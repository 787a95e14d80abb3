"""ray_tpu_torch's cost receipts, anomaly detector and black box against
ray_tpu's.

- receipts: on one workload (mixed prefill and decode ticks, prefix
  sharing, a manual preempt whose spill moves a power-of-two page count)
  the per-request receipts' flops, hbm_bytes and kv_page_ticks, and every
  conserved field, equal the JAX engine's exactly; the tick compositions
  agree tick by tick; summed receipts equal the accountant's tick totals,
  greedy and sampled;
- a spill of a page count that is not a power of two: the port charges
  the pages it moves, the JAX engine the power-of-two count its padded
  gather moves (the one departure, ROADMAP §C);
- the anomaly detector flags the same ticks with the same classes as the
  JAX one on the same synthetic stream; on the engine, a cold ragged
  bucket after the warm-up is flagged "recompile" with its capture;
- a black-box bundle has the JAX bundle's keys.

The JAX side is the gather engine with async_readback=False; the port
runs async_readback=False on the CPU with the JAX engine's weights.
"""

import gc
import time
import types
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import anomaly as ja
from ray_tpu.llm._internal import engine as je
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm._internal import anomaly as ta
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.llm._internal.attribution import CONSERVED_FIELDS
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)

COMMON = dict(max_batch_size=3, page_size=8, num_pages=64, seed=11,
              max_prefill_tokens=16, async_readback=False)
_PARAMS = {}


def _jax_engine(**over):
    kw = dict(COMMON, model=jl.config("debug", dtype=jnp.float32),
              prefill_buckets=(16, 32, 64), decode_impl="gather",
              metrics_model_id=f"aj{uuid.uuid4().hex[:10]}")
    kw.update(over)
    return je.InferenceEngine(je.EngineConfig(**kw))


def _params():
    if not _PARAMS:
        _PARAMS.update(jax.tree_util.tree_map(
            np.asarray, _jax_engine().params))
    return _PARAMS


def _engine(**over):
    kw = dict(COMMON, model=tl.config("debug", dtype=torch.float32),
              device="cpu", metrics_model_id=f"at{uuid.uuid4().hex[:10]}")
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw), params=_params())


def _drive_mixed(eng, mod, sampled=False, n_req=10, preempt_at=12,
                 spill_pages=None):
    """The JAX attribution suite's seeded bursty workload: requests of
    3 tenants arrive in bursts, one decoding request is preempted at
    tick `preempt_at` (with `spill_pages`: the first whose cache then
    spans exactly that many pages). Returns the requests and the tick
    compositions ((kind, decode tokens, prefill tokens) a tick)."""
    rng = np.random.default_rng(7)
    reqs = [mod.Request(
        f"c{i}", rng.integers(2, 250, 12 + 4 * (i % 3)).tolist(),
        mod.SamplingParams(
            max_tokens=16 + 8 * (i % 2),
            temperature=(0.8 if sampled and i % 2 else 0.0),
            top_k=(20 if sampled and i % 2 else 0)),
        tenant=("acme" if i % 3 == 0 else ""))
        for i in range(n_req)]
    pending = list(reqs)
    steps = 0
    preempted = False
    ticks = []
    while eng.has_work() or pending:
        if pending and steps % 4 == 0:
            for r in pending[:3]:
                eng.add_request(r)
            pending = pending[3:]
        eng.step()
        steps += 1
        if eng.perf.window():
            t = eng.perf.window()[-1]
            ticks.append((steps, t.kind, t.decode_tokens, t.prefill_tokens))
        if steps >= preempt_at and not preempted:
            for s in eng.slots:
                if s.request is None or not s.ready:
                    continue
                n = eng.allocator.pages_needed(s.position)
                if spill_pages is None or n == spill_pages:
                    preempted = eng.preempt(s.request.request_id,
                                            reason="manual")
                    break
    assert all(r.finished for r in reqs)
    assert preempted or preempt_at > 10 ** 6
    return reqs, sorted(set(ticks))


@pytest.fixture(scope="module")
def jax_greedy():
    eng = _jax_engine(enable_kv_offload=True)
    reqs, ticks = _drive_mixed(eng, je, spill_pages=2)
    return eng, reqs, ticks


def test_receipts_equal_jax(jax_greedy):
    jeng, jreqs, jticks = jax_greedy
    eng = _engine(enable_kv_offload=True)
    reqs, ticks = _drive_mixed(eng, te, spill_pages=2)
    assert [r.output_tokens for r in reqs] == \
        [r.output_tokens for r in jreqs]
    assert ticks == jticks                 # the same tick compositions
    assert eng.host_tier.spills_total == jeng.host_tier.spills_total == 1
    for r in reqs:
        mine = eng.attrib.receipt(r.request_id)
        ref = jeng.attrib.receipt(r.request_id)
        assert (mine.flops, mine.hbm_bytes, mine.kv_page_ticks) == \
            (ref.flops, ref.hbm_bytes, ref.kv_page_ticks), r.request_id
        for _, attr in CONSERVED_FIELDS:
            assert getattr(mine, attr) == getattr(ref, attr), attr
        assert (mine.ticks, mine.tenant, mine.finish_reason) == \
            (ref.ticks, ref.tenant, ref.finish_reason)
    assert eng.attrib.totals() == jeng.attrib.totals()
    counted = ("requests", "flops", "hbm_bytes", "kv_page_ticks",
               "decode_tokens", "prefill_tokens")
    mine, ref = eng.attrib.tenants(), jeng.attrib.tenants()
    assert set(mine) == set(ref) == {"default", "acme"}
    for t in ref:
        assert {k: mine[t][k] for k in counted} == \
            {k: ref[t][k] for k in counted}
    assert eng.perf.totals()["flops"] == jeng.perf.totals()["flops"]


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_receipt_conservation_exact(sampled):
    eng = _engine(enable_kv_offload=True)
    _drive_mixed(eng, te, sampled=sampled)
    assert eng.host_tier.spills_total >= 1
    assert eng.host_tier.restores_total >= 1
    pt = eng.perf.totals()
    at = eng.attrib.totals()
    for key, _ in CONSERVED_FIELDS:
        assert pt[key] == at[key], key
    assert at["bytes_d2h"] > 0 and at["bytes_h2d"] > 0
    summ = eng.attrib.summary()
    assert summ["live"] == 0 and summ["requests_total"] == 10
    wall = sum(eng.attrib.receipt(f"c{i}").wall_ms for i in range(10))
    assert wall == pytest.approx(sum(t.wall_ms for t in eng.perf.window()),
                                 rel=1e-6)


def test_spill_charges_the_pages_moved():
    """A 3-page spill: the port's gather moves 3 pages and charges 3,
    the JAX engine pads its gather to 4 and charges 4."""
    jeng = _jax_engine(enable_kv_offload=True)
    eng = _engine(enable_kv_offload=True)
    _drive_mixed(jeng, je, spill_pages=3)
    _drive_mixed(eng, te, spill_pages=3)
    pb = eng.perf.model.page_bytes
    assert pb == jeng.perf.model.page_bytes
    assert eng.perf.totals()["bytes_d2h"] == 3 * pb
    assert jeng.perf.totals()["bytes_d2h"] == 4 * pb
    # the restore uploads the pages the prefix cache does not share
    assert eng.perf.totals()["bytes_h2d"] % pb == 0
    assert eng.attrib.totals()["bytes_d2h"] == 3 * pb


def test_finish_event_stats_and_usage_cost():
    eng = _engine()
    _drive_mixed(eng, te, preempt_at=10 ** 9)
    rets = [e for e in eng.telemetry.recorder.events()
            if e["event"] == "retirement"]
    assert rets and all("cost" in e for e in rets)
    for key in ("flops", "hbm_bytes", "kv_page_ticks", "wall_ms",
                "queue_ms", "decode_tokens", "prefill_tokens"):
        assert key in rets[-1]["cost"]
    s = eng.stats()["attribution"]
    assert s["enabled"] and s["requests_total"] == 10
    assert s["top"][0]["flops"] >= s["top"][-1]["flops"]
    assert set(s["tenants"]) == {"default", "acme"}
    assert s["tenants"]["acme"]["requests"] == 4
    assert eng.attribution_summary(top_k=2)["top"] == s["top"][:2]
    off = _engine(enable_attribution=False, enable_anomaly_detection=False)
    _drive_mixed(off, te, preempt_at=10 ** 9)
    assert off.stats()["attribution"] == {"enabled": False}
    assert off.stats()["anomaly"] == {"enabled": False}


# ---------------------------------------------------------------- anomaly

class _S:
    """A PerfSample-shaped tick."""

    def __init__(self, flops=2e9, hbm=1e9, h2d=0.0, kind="decode"):
        self.flops, self.hbm_bytes, self.bytes_h2d = flops, hbm, h2d
        self.bytes_d2h, self.kind, self.dispatches = 0.0, kind, 1
        self.decode_tokens, self.prefill_tokens = 3, 0


class _GcStub:
    def __init__(self):
        self.total = 0.0
        self.collections = 0

    def snapshot(self):
        return self.total


def _stream():
    """(sample, wall, host, device, compiles, gc seconds added before the
    tick) of a synthetic run: a warm-up of noisy steady ticks, then one
    outlier of every class, steady ticks between, and a slow drift."""
    rng = np.random.default_rng(3)
    out = []
    compiles = 5
    for i in range(300):
        wall = float(2.0 * np.exp(rng.normal(0, 0.05)))
        host, dev, sample, gc_s = 0.2, 0.1, _S(), 0.0
        if i in (80, 81, 160):
            compiles += 1
            wall = 40.0
        elif i == 100:
            sample, wall = _S(h2d=4096.0), 35.0
        elif i == 120:
            gc_s, wall = 0.030, 40.0
        elif i == 140:
            host, wall = 36.0, 40.0
        elif i == 180:
            dev, wall = 30.0, 40.0
        elif i in (200, 201):
            wall = 50.0
        elif i >= 250:
            wall *= 1.0 + (i - 250) * 0.02
        out.append((sample, wall, host, dev, compiles, gc_s))
    return out


def _run_detector(mod):
    det = mod.TickAnomalyDetector(mod.AnomalyConfig(
        warmup_ticks=32, min_wall_ms=0.1,
        profile_min_interval_s=10.0, dump_min_interval_s=25.0))
    det._gc = _GcStub()
    det._gc_prev = 0.0
    flags = []
    for i, (sample, wall, host, dev, compiles, gc_s) in \
            enumerate(_stream()):
        det._gc.total += gc_s
        ev = det.observe(sample, wall, host, dev, compiles, 1e12, 1e12,
                         now=float(i))
        if ev is not None:
            flags.append((i, ev))
    return det, flags


def test_anomaly_detector_flags_as_jax():
    gc.disable()
    try:
        jdet, jflags = _run_detector(ja)
        tdet, tflags = _run_detector(ta)
    finally:
        gc.enable()
    assert tflags == jflags
    kinds = {ev["kind"] for _, ev in tflags}
    assert kinds >= {"recompile", "h2d_transfer", "gc_pause",
                     "host_fold_stall", "device_straggler", "unknown"}
    assert [e["arm_profile"] for _, e in tflags] == \
        [e["arm_profile"] for _, e in jflags]
    st, jst = tdet.stats(), jdet.stats()
    for k in ("ticks", "warmed", "anomalies_total", "by_kind", "rate",
              "last"):
        assert st[k] == jst[k], k


def test_forced_recompile_produces_classified_capture(monkeypatch):
    """A cold ragged bucket after the warm-up (a prompt far past every
    bucket the steady state used), whose first tick stalls as a build
    would (the CPU builds nothing): a tick_anomaly event classified
    recompile, an auto-armed profile, a black-box bundle.

    The stall is a jump of the engine's clock, not a sleep: on a loaded
    machine (six test workers) the warm ticks' log-walls spread by a
    MAD of ~0.5-0.7, so the robust z-score needs a stall of minutes
    before it clears 6, and a 0.3 s sleep went unflagged. Only events
    after the warm-up are judged: a warm tick flagged under load is not
    the cold one."""
    eng = _engine(max_batch_size=4, num_pages=128, async_readback=True,
                  anomaly={"warmup_ticks": 16, "z_threshold": 6.0,
                           "min_wall_ms": 0.0,
                           "profile_min_interval_s": 0.0,
                           "dump_min_interval_s": 0.0})
    rng = np.random.default_rng(5)
    for i in range(3):
        eng.add_request(te.Request(f"s{i}", rng.integers(2, 250, 12).tolist(),
                                   te.SamplingParams(max_tokens=200)))
    while eng.waiting or any(s.request is not None and not s.ready
                             for s in eng.slots):
        eng.step()
    for _ in range(40):
        eng.step()
    assert eng.anomaly.stats()["warmed"]
    base = eng.anomaly.anomalies_total
    seq0 = eng.telemetry.recorder.stats()["total"]
    bundles0 = {b["id"] for b in eng.blackbox.list()}
    eng.add_request(te.Request("long", rng.integers(2, 250, 120).tolist(),
                               te.SamplingParams(max_tokens=4)))
    comp0 = eng.compiles
    ragged = eng._ragged_step
    offset = [0.0]
    clock = types.SimpleNamespace(**{n: getattr(time, n) for n in dir(time)
                                     if not n.startswith("_")})
    clock.perf_counter = lambda: time.perf_counter() + offset[0]
    monkeypatch.setattr(te, "time", clock)

    def cold_first_tick(touched):
        if eng.compiles == comp0:
            offset[0] += 600.0         # the build's stall, on the clock
        ragged(touched)
    monkeypatch.setattr(eng, "_ragged_step", cold_first_tick)
    for _ in range(30):
        eng.step()
        if eng.anomaly.anomalies_total > base:
            break
    assert eng.compiles > comp0
    events = eng.telemetry.recorder.events(since=seq0)
    anoms = [e for e in events if e["event"] == "tick_anomaly"]
    assert anoms and anoms[0]["anomaly_kind"] == "recompile"
    assert anoms[0]["compile_delta"] >= 1
    assert any(e["event"] == "profile_armed"
               and e.get("trigger") == "tick_anomaly" for e in events)
    bid = next(b["id"] for b in eng.blackbox.list()
               if b["cause"] == "tick_anomaly" and b["id"] not in bundles0)
    bundle = eng.blackbox.read(bid)
    assert bundle["anomaly_event"]["kind"] == "recompile"
    assert bundle["anomaly"]["anomalies_total"] >= 1
    # an auto-arm while a capture is pending is a no-op
    while eng._profile is not None:
        eng.step()
    eng.profile_next_ticks(2)
    assert eng._arm_profile_locked(2) is None


def test_blackbox_bundle_keys_equal_jax():
    jeng = _jax_engine(enable_kv_offload=True)
    eng = _engine(enable_kv_offload=True)
    for e, mod in ((jeng, je), (eng, te)):
        for i in range(2):
            e.add_request(mod.Request(f"b{i}", [5 + i] * 9,
                                      mod.SamplingParams(max_tokens=8)))
        for _ in range(3):
            e.step()
    jb = jeng.blackbox.read(jeng.dump_blackbox("manual"))
    tb = eng.blackbox.read(eng.dump_blackbox("manual"))
    assert set(tb) == set(jb)
    assert set(tb["counters"]) == set(jb["counters"])
    assert tb["in_flight_requests"] and tb["slots"]
    assert [s["request_id"] for s in tb["slots"]] == \
        [s["request_id"] for s in jb["slots"]]
    assert "ray_tpu_llm_ttft_seconds" in tb["metrics_exposition"]
    disabled = _engine(enable_blackbox=False)
    assert disabled.dump_blackbox("manual") is None
