"""Multi-window SLO burn-rate watchdog for the serving fleet.

The port's own copy of ``ray_tpu/serve/llm/watchdog.py``: the
multi-window burn-rate alert over the fleet's summed
`EngineTelemetry.slo_totals()` (monotone totals with `*_bad` violation
counts per SLO target):

    burn = (bad / total in window) / (1 - objective)

i.e. how many times faster than "allowed" the fleet is consuming its
error budget. A burn of 1.0 exactly spends the budget; sustained burn
over `page_burn_rate` in BOTH the short and long windows pages. Two
windows make the alert both fast (the short window reacts in seconds)
and flap-proof (the long window ignores a single bad tick); recovery
requires the short window to cool below `warn_burn_rate`, so a page
doesn't clear on one good second.

Consumers, wired by FleetManager:
- `slo_burn_rate{slo,window}` gauges + `slo_alerts_total{slo}` counter
  in this process's Prometheus registry (rides the fleet /metrics);
- an `slo_alert` flight-recorder event on every page transition
  (plus `slo_clear` on recovery);
- `paging` — the pre-emptive signal: the autoscaler treats it as an
  instant breach (scale up BEFORE the SLO is blown) and admission
  engages brownout (shed early, shed cheap) while it holds.

Pure host-side control-plane math on snapshots the fleet already
collects: zero engine involvement, zero device syncs.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from ...util import metrics as metrics_api

# slo name -> (observation-count key, violation-count key) in the
# summed slo_totals() dict
_SLO_KEYS = {
    "ttft": ("ttft_n", "ttft_bad"),
    "queue_wait": ("queue_n", "queue_bad"),
    "e2e": ("e2e_n", "e2e_bad"),
}


@dataclasses.dataclass
class WatchdogConfig:
    enabled: bool = True
    # fraction of requests that must meet each SLO target (the error
    # budget is 1 - objective)
    objective: float = 0.9
    # multi-window lengths: short reacts, long de-flaps
    short_window_s: float = 30.0
    long_window_s: float = 300.0
    # burn thresholds: BOTH windows over page_burn_rate -> page;
    # recovery needs the short window back under warn_burn_rate
    page_burn_rate: float = 2.0
    warn_burn_rate: float = 1.0
    # windows with fewer observations than this are judged quiet
    # (burn 0) — two bad requests out of three must not page a fleet
    min_observations: int = 8
    slos: Tuple[str, ...] = ("ttft", "queue_wait", "e2e")
    # KV page pressure: (device pages used + parked host
    # pages) / usable, max over active replicas. Sustained demand
    # past `high` flags pressure_state="high" (alert + gauge);
    # recovery needs it back under `warn` (hysteresis). Whether high
    # pressure also BROWNOUTS the front door depends on spillability:
    # FleetManager sheds only when the pressured replicas cannot
    # spill — pages short but spillable is a latency tier the
    # admission queue absorbs, not overload.
    page_pressure_high: float = 1.5
    page_pressure_warn: float = 1.0
    # consecutive observations over `high` before flagging (one
    # bursty probe must not alert)
    page_pressure_count: int = 2
    # Tick-anomaly page PRECURSOR: max recent anomaly rate
    # over active replicas (from each engine's TickAnomalyDetector).
    # Sustained rate past `high` flags anomaly_state="high" — an
    # early-warning alert BEFORE SLO burn shows up (a stalling/
    # recompiling replica goes anomalous ticks before it goes slow
    # enough to burn budget); recovery needs it back under `warn`.
    # Watch-only: it never brownouts the front door on its own.
    anomaly_rate_high: float = 0.25
    anomaly_rate_warn: float = 0.10
    anomaly_count: int = 2


class SLOBurnWatchdog:
    """Feed `observe()` monotone fleet-summed slo_totals; read
    `paging` / `state` / `last`. Injectable `now` for tests."""

    def __init__(self, config: Optional[WatchdogConfig] = None,
                 recorder: Any = None,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config or WatchdogConfig()
        # injectable clock: burn windows are pure deltas
        # over whatever monotone time source drives observe() — the
        # fleet simulator passes its virtual clock here
        self._clock = clock if clock is not None else time.monotonic
        unknown = set(self.config.slos) - set(_SLO_KEYS)
        if unknown:
            # fail at fleet build, not as a KeyError on every control-
            # loop tick (slos is wire-exposed through FleetConfig)
            raise ValueError(
                f"unknown watchdog slo(s) {sorted(unknown)}; "
                f"tracked: {sorted(_SLO_KEYS)}")
        self.recorder = recorder           # FlightRecorder-compatible
        self._snaps: Deque[Tuple[float, Dict[str, float]]] = \
            collections.deque()
        self.state: Dict[str, str] = {s: "ok" for s in self.config.slos}
        self.last: Dict[str, Any] = {}
        self.paging = False
        self.max_burn = 0.0
        self.alerts_total = 0
        self._burn_gauge = metrics_api.Gauge(
            "ray_tpu_llm_slo_burn_rate",
            "error-budget burn rate per SLO and window "
            "(1.0 = spending exactly the budget)",
            ("slo", "window"))
        self._alerts = metrics_api.Counter(
            "ray_tpu_llm_slo_alerts_total",
            "watchdog page transitions per SLO", ("slo",))
        # KV page-pressure monitor
        self.pressure_state = "ok"
        self.last_pressure = 0.0
        self._pressure_over = 0
        self._pressure_gauge = metrics_api.Gauge(
            "ray_tpu_llm_fleet_page_pressure",
            "max KV page pressure over active replicas "
            "((used + parked host pages) / usable; > 1 = "
            "oversubscribed)")
        # tick-anomaly page precursor
        self.anomaly_state = "ok"
        self.last_anomaly_rate = 0.0
        self._anomaly_over = 0
        self._anomaly_gauge = metrics_api.Gauge(
            "ray_tpu_llm_fleet_anomaly_rate",
            "max recent tick-anomaly rate over active replicas "
            "(the SLO-page precursor signal)")

    # -- burn math -----------------------------------------------------
    def _window_delta(self, horizon: float, cur: Dict[str, float],
                      n_key: str, bad_key: str) -> Tuple[float, float]:
        """Delta of (observations, violations) since the newest
        snapshot at or before `horizon` (falling back to the oldest —
        a young watchdog judges over its whole history)."""
        base: Optional[Dict[str, float]] = None
        for ts, totals in self._snaps:
            if ts <= horizon:
                base = totals
            else:
                break
        if base is None and self._snaps:
            base = self._snaps[0][1]
        if base is None:
            return 0.0, 0.0
        return (max(cur.get(n_key, 0.0) - base.get(n_key, 0.0), 0.0),
                max(cur.get(bad_key, 0.0) - base.get(bad_key, 0.0),
                    0.0))

    def _burn(self, horizon: float, cur: Dict[str, float],
              n_key: str, bad_key: str) -> "Tuple[float, float]":
        """(burn rate, observations) for the window; a window below
        min_observations judges burn 0 — but the caller still needs n
        to distinguish 'healthy' from 'no evidence' (a stalled fleet
        must not read as recovered)."""
        n, bad = self._window_delta(horizon, cur, n_key, bad_key)
        if n < self.config.min_observations:
            return 0.0, n
        budget = max(1.0 - self.config.objective, 1e-6)
        return (bad / n) / budget, n

    # -- page pressure --------------------------------------
    def observe_pressure(self, pressure: float) -> bool:
        """One page-pressure observation (fleet max). Sets the gauge,
        drives the hysteretic ok/high state, records alert/clear
        flight-recorder events. Returns True when the state changed.
        The caller (FleetManager) decides the brownout reaction using
        fleet spillability — this monitor only watches."""
        cfg = self.config
        self.last_pressure = float(pressure)
        self._pressure_gauge.set(round(self.last_pressure, 4))
        prev = self.pressure_state
        if self.last_pressure >= cfg.page_pressure_high:
            self._pressure_over += 1
            if self._pressure_over >= cfg.page_pressure_count:
                self.pressure_state = "high"
        elif self.last_pressure < cfg.page_pressure_warn:
            self._pressure_over = 0
            self.pressure_state = "ok"
        else:
            self._pressure_over = 0      # warn band: hold state
        changed = self.pressure_state != prev
        if changed and self.recorder is not None:
            self.recorder.record(
                "page_pressure_alert" if self.pressure_state == "high"
                else "page_pressure_clear",
                pressure=round(self.last_pressure, 4),
                high=cfg.page_pressure_high)
        return changed

    # -- tick-anomaly precursor -----------------------------
    def observe_anomaly(self, rate: float) -> bool:
        """One fleet-max anomaly-rate observation. Same hysteretic
        shape as observe_pressure: consecutive readings over `high`
        flag, recovery under `warn` clears, alert/clear land in the
        flight recorder. Watch-only — the point is a page PRECURSOR:
        the alert fires while the SLO budget is still intact, so an
        operator (or the postmortem reader) sees the anomaly storm
        that preceded the burn. Returns True on a state change."""
        cfg = self.config
        self.last_anomaly_rate = float(rate)
        self._anomaly_gauge.set(round(self.last_anomaly_rate, 4))
        prev = self.anomaly_state
        if self.last_anomaly_rate >= cfg.anomaly_rate_high:
            self._anomaly_over += 1
            if self._anomaly_over >= cfg.anomaly_count:
                self.anomaly_state = "high"
        elif self.last_anomaly_rate < cfg.anomaly_rate_warn:
            self._anomaly_over = 0
            self.anomaly_state = "ok"
        else:
            self._anomaly_over = 0       # warn band: hold state
        changed = self.anomaly_state != prev
        if changed and self.recorder is not None:
            self.recorder.record(
                "anomaly_rate_alert" if self.anomaly_state == "high"
                else "anomaly_rate_clear",
                rate=round(self.last_anomaly_rate, 4),
                high=cfg.anomaly_rate_high)
        return changed

    # -- the tick ------------------------------------------------------
    def observe(self, totals: Dict[str, float],
                now: Optional[float] = None,
                idle: bool = False) -> Dict[str, Any]:
        """One watchdog evaluation over the fleet-summed monotone
        totals. Returns (and stores in .last) the per-SLO report.

        `idle=True` asserts the caller sees NO interactive demand
        anywhere (front door empty, zero interactive requests queued
        or decoding on any replica): an empty short window then means
        a healthy trough, and a held page clears. Without it, zero
        observations under a page read as a total stall — requests
        arriving but nothing completing — and the page holds (a
        post-burst page latched through an idle trough wedged
        brownout shut and starved the batch lane forever)."""
        cfg = self.config
        if not cfg.enabled:
            return {}
        now = self._clock() if now is None else now
        report: Dict[str, Any] = {}
        for slo in cfg.slos:
            n_key, bad_key = _SLO_KEYS[slo]
            short, short_n = self._burn(now - cfg.short_window_s,
                                        totals, n_key, bad_key)
            long_, _ = self._burn(now - cfg.long_window_s, totals,
                                  n_key, bad_key)
            self._burn_gauge.set(round(short, 4),
                                 {"slo": slo, "window": "short"})
            self._burn_gauge.set(round(long_, 4),
                                 {"slo": slo, "window": "long"})
            prev = self.state[slo]
            if min(short, long_) >= cfg.page_burn_rate:
                state = "page"
            elif prev == "page" and (
                    short >= cfg.warn_burn_rate
                    or (short_n < cfg.min_observations
                        and not idle)):
                # hysteresis: recovery needs EVIDENCE — a cooled short
                # window with enough observations. A totally stalled
                # fleet (zero new requests) is the outage at its
                # worst, not recovery; hold the page until traffic
                # flows again. EXCEPT when the caller vouches the
                # fleet is demand-idle (`idle=True`): an empty window
                # over an empty fleet is a trough, and holding the
                # page there would latch brownout with nobody left to
                # shed.
                state = "page"
            elif min(short, long_) >= cfg.warn_burn_rate:
                state = "warn"
            else:
                state = "ok"
            if state == "page" and prev != "page":
                self.alerts_total += 1
                self._alerts.inc(1, {"slo": slo})
                if self.recorder is not None:
                    self.recorder.record(
                        "slo_alert", slo=slo,
                        burn_short=round(short, 3),
                        burn_long=round(long_, 3),
                        objective=cfg.objective)
            elif state != "page" and prev == "page" \
                    and self.recorder is not None:
                self.recorder.record("slo_clear", slo=slo,
                                     burn_short=round(short, 3))
            self.state[slo] = state
            report[slo] = {"burn_short": round(short, 4),
                           "burn_long": round(long_, 4),
                           "state": state}
        # retain one snapshot older than the long window as the
        # baseline, prune the rest
        self._snaps.append((now, dict(totals)))
        horizon = now - cfg.long_window_s
        while len(self._snaps) > 1 and self._snaps[1][0] <= horizon:
            self._snaps.popleft()
        self.paging = any(st == "page" for st in self.state.values())
        self.max_burn = max(
            (min(r["burn_short"], r["burn_long"])
             for r in report.values()), default=0.0)
        self.last = report
        return report


__all__ = ["WatchdogConfig", "SLOBurnWatchdog"]
