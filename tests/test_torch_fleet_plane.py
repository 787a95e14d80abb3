"""ray_tpu_torch's fleet plane against ray_tpu's, module by module.

The serving fleet's policy objects are host code, deterministic given
their inputs and clocks. Each case below drives the JAX package's
module and the port's with the same scripted inputs (injected clocks,
pinned ids and wall anchors) and requires equal decisions, state,
bytes and metric families: the ring's placement of 512 keys, prefix
fingerprints and snapshots, the router's picks over a scripted
sequence, admission, autoscaling, the burn-rate watchdog, the circuit
breaker, stream transcripts and their continuations and SSE chunks,
the chaos schedule, the trace and flight-recorder merges, traffic
captures byte for byte with their typed errors, the prefix store's
eviction order, `INTERNAL_BODY_KEYS` and the metric families of the
fleet, transport, admission and watchdog. No engine runs here.
"""

import asyncio
import dataclasses
import json
import types

import pytest

import ray_tpu.llm._internal.server as j_server
import ray_tpu.llm._internal.telemetry as j_telemetry
import ray_tpu.serve.llm.admission as j_admission
import ray_tpu.serve.llm.autoscaler as j_autoscaler
import ray_tpu.serve.llm.chaos as j_chaos
import ray_tpu.serve.llm.failover as j_failover
import ray_tpu.serve.llm.kv_transport as j_kvt
import ray_tpu.serve.llm.router as j_router
import ray_tpu.serve.llm.tracemerge as j_tracemerge
import ray_tpu.serve.llm.trafficlog as j_trafficlog
import ray_tpu.serve.llm.watchdog as j_watchdog
import ray_tpu_torch.llm._internal.server as t_server
import ray_tpu_torch.llm._internal.telemetry as t_telemetry
import ray_tpu_torch.serve.llm.admission as t_admission
import ray_tpu_torch.serve.llm.autoscaler as t_autoscaler
import ray_tpu_torch.serve.llm.chaos as t_chaos
import ray_tpu_torch.serve.llm.failover as t_failover
import ray_tpu_torch.serve.llm.kv_transport as t_kvt
import ray_tpu_torch.serve.llm.router as t_router
import ray_tpu_torch.serve.llm.tracemerge as t_tracemerge
import ray_tpu_torch.serve.llm.trafficlog as t_trafficlog
import ray_tpu_torch.serve.llm.watchdog as t_watchdog

JAX = types.SimpleNamespace(
    server=j_server, telemetry=j_telemetry, admission=j_admission,
    autoscaler=j_autoscaler, chaos=j_chaos, failover=j_failover,
    kvt=j_kvt, router=j_router, tracemerge=j_tracemerge,
    trafficlog=j_trafficlog, watchdog=j_watchdog)
PORT = types.SimpleNamespace(
    server=t_server, telemetry=t_telemetry, admission=t_admission,
    autoscaler=t_autoscaler, chaos=t_chaos, failover=t_failover,
    kvt=t_kvt, router=t_router, tracemerge=t_tracemerge,
    trafficlog=t_trafficlog, watchdog=t_watchdog)


class Clock:
    """A scripted monotonic clock."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _events(recorder):
    """Flight-recorder events without their wall stamps."""
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in recorder.events()]


# ------------------------------------------------------------ the ring

def _ring_walks(M, n_nodes):
    ring = M.router.HashRing(vnodes=64)
    nodes = [f"replica-{i}" for i in range(n_nodes)]
    for n in nodes:
        ring.add(n)
    keys = [f"key-{i}" for i in range(512)]
    before = [list(ring.preferred(k)) for k in keys]
    ring.remove(nodes[1])
    after = [list(ring.preferred(k)) for k in keys]
    ring.add(nodes[1])
    again = [list(ring.preferred(k)) for k in keys]
    return before, after, again


@pytest.mark.parametrize("n_nodes", [2, 3, 4, 5])
def test_hash_ring_places_every_key_as_jax(n_nodes):
    want = _ring_walks(JAX, n_nodes)
    got = _ring_walks(PORT, n_nodes)
    assert got == want
    before, after, again = got
    assert again == before               # history-independent
    # removal moves only the removed node's keys
    moved = sum(b[0] != a[0] for b, a in zip(before, after))
    owned = sum(b[0] == "replica-1" for b in before)
    assert moved == owned > 0


# ------------------------------------------------------------ the cases

_SYS = {"role": "system", "content": "You are a terse assistant. " * 4}


def case_fingerprints(M, mp):
    fp = M.router.prefix_fingerprint
    bodies = [
        {"prompt": "the shared prefix " * 20},
        {"prompt": "the shared prefix " * 20 + "tail"},
        {"prompt": "short"},
        {"prompt": ""},
        {"messages": [_SYS, {"role": "user", "content": "hi"}]},
        {"messages": [_SYS, {"role": "user", "content": "bye"}]},
        {"messages": [{"role": "user", "content": _SYS["content"]}]},
        {"messages": []},
    ]
    out = [fp(b, d) for b in bodies for d in (16, 64, 256, 1024)]
    assert len(set(out)) > 8
    return out


_STATS = {
    "replica": "r3", "active": 5, "waiting": 7, "chips": 1,
    "waiting_batch": 2, "active_batch": 1, "kv_occupancy_batch": 0.125,
    "kv_occupancy": 0.6, "free_pages": 40, "cache_hit_rate": 0.375,
    "last_tick_age_s": 0.25, "page_pressure": 0.7,
    "parked_sessions": 3, "kv_offload": True,
    "kv_host_bytes_used": 123456,
    "perf": {"mfu": 0.125, "mbu": 0.5, "decode_tokens_per_s": 900.0,
             "prefill_tokens_per_s": 4000.0, "roof": "memory"},
    "anomaly": {"rate": 0.0625, "total": 4, "last_kind": "slow_tick"},
}


def case_snapshot_from_stats(M, mp):
    out = []
    for stats in (_STATS, {"replica": "r0"}, {**_STATS, "chips": 0}):
        d = dataclasses.asdict(M.router.ReplicaSnapshot.from_stats(stats))
        d.pop("ts")
        d.pop("mono_ts")
        out.append(d)
    snap = M.router.ReplicaSnapshot.from_stats(_STATS)
    out.append([snap.displaceable_waiting(), snap.interactive_occupancy()])
    return out


def _snap(M, rid, now, occ=0.0, waiting=0, active=0, age=0.0,
          waiting_batch=0, occ_batch=0.0):
    return M.router.ReplicaSnapshot(
        replica=rid, kv_occupancy=occ, waiting=waiting, active=active,
        waiting_batch=waiting_batch, kv_occupancy_batch=occ_batch,
        mono_ts=now - age)


def case_router_sequence(M, mp):
    clock = Clock()
    r = M.router.FleetRouter(M.router.RouterConfig(vnodes=16),
                             clock=clock)
    r.set_replicas(["r0", "r1", "r2"])
    fps = [M.router.prefix_fingerprint({"prompt": f"prefix {i} " * 30})
           for i in range(6)]
    now = clock.t
    calm = {rid: _snap(M, rid, now) for rid in ("r0", "r1", "r2")}
    out = []
    for fp in fps:                                      # affinity
        out.append(r.pick_ex(fp, calm, {}))
    for occ, waiting in ((0.95, 0), (0.1, 99), (0.9, 0)):   # spill
        snaps = {rid: _snap(M, rid, now, occ=occ, waiting=waiting)
                 if rid == r.ring.preferred(fps[0])[0] else calm[rid]
                 for rid in calm}
        out.append(r.pick_ex(fps[0], snaps, {}))
    out.append(r.pick_ex(fps[1], calm,                 # in-flight
                         {r.ring.preferred(fps[1])[0]: 4}))
    allsat = {rid: _snap(M, rid, now, occ=0.9 + 0.03 * i, waiting=9 - i)
              for i, rid in enumerate(("r0", "r1", "r2"))}
    for fp in fps[:3]:                                  # scored
        out.append(r.pick_ex(fp, allsat, {"r1": 2}))
    stale = {rid: _snap(M, rid, now, age=60.0 if rid == "r2" else 0.0)
             for rid in calm}
    for fp in fps:                                      # stale
        out.append(r.pick_ex(fp, stale, {}))
    batch = {rid: _snap(M, rid, now, occ=0.9, occ_batch=0.5,
                        waiting=6, waiting_batch=5) for rid in calm}
    out.append(r.pick_ex(fps[2], batch, {}))           # displaceable
    out.append([round(r.score(s, 1), 9) for s in allsat.values()])
    r.set_replicas(["r0", "r2"])
    out += [r.pick_ex(fp, calm, {}) for fp in fps]
    out.append(r.stats())
    rr = M.router.FleetRouter(M.router.RouterConfig(policy="round_robin"),
                              clock=clock)
    rr.set_replicas(["r1", "r0"])
    out += [rr.pick_ex(fps[0], calm, {}) for _ in range(5)]
    out.append(M.router.FleetRouter().pick_ex(fps[0], {}, {}))
    kinds = {o[1] for o in out if isinstance(o, tuple)}
    assert kinds == {"affinity", "spill", "scored", "round_robin",
                     "none"}
    return out


def case_admission_sync(M, mp):
    clock = Clock()
    Rej = M.admission.AdmissionRejected
    adm = M.admission.AdmissionController(
        M.admission.AdmissionConfig(
            max_concurrent=2, max_queue=4, queue_wait_slo_s=1.0,
            tenant_weights={"A": 3.0, "B": 1.0}),
        clock=clock)
    out = []

    def submit(tenant, deadline=None):
        try:
            t = adm.submit(tenant, deadline=deadline)
            out.append(("ticket", t.tenant, round(t.vtime, 9),
                        t.granted))
        except Rej as e:
            out.append(("rejected", tenant, e.reason, e.retry_after_s))

    for tenant in ("A", "B", "A", "A", "B", "A", "C"):
        submit(tenant)
        clock.t += 0.1
    out.append([t.tenant for t in adm.granted_sync()])
    submit("D", deadline=clock.t - 1.0)           # already expired
    adm.release()
    out.append([t.tenant for t in adm.granted_sync()])
    clock.t += 0.5
    submit("E", deadline=clock.t + 0.2)
    clock.t += 0.3
    out.append([(t.tenant, t.deadline is not None)
                for t in adm.shed_expired()])
    clock.t += 1.0
    out.append([t.tenant for t in adm.shed_expired()])
    adm.set_brownout(True)
    for tenant in ("F", "G", "H"):
        submit(tenant)
    out.append([adm.would_reject(), adm.retry_after()])
    adm.set_page_pressure(1.2, False)
    out.append(adm.set_brownout(False))
    adm.release()
    adm.release()
    out.append([t.tenant for t in adm.granted_sync()])
    out.append(adm.stats())
    reasons = {o[2] for o in out if isinstance(o, tuple)
               and o[0] == "rejected"}
    assert {"deadline", "queue_full", "brownout"} <= reasons
    return out


def case_admission_async(M, mp):
    """The asyncio front door: queue_full, SLO sheds, weighted-fair
    grants, deadlines (real timers, short)."""
    Rej = M.admission.AdmissionRejected

    async def main():
        out = []
        adm = M.admission.AdmissionController(M.admission.AdmissionConfig(
            max_concurrent=1, max_queue=8, queue_wait_slo_s=5.0,
            tenant_weights={"A": 3.0, "B": 1.0}))
        await adm.acquire("hog")
        grants = []

        async def one(tenant):
            await adm.acquire(tenant)
            grants.append(tenant)

        tasks = [asyncio.create_task(one(t))
                 for t in ("A",) * 6 + ("B",) * 2]
        await asyncio.sleep(0.01)
        try:
            await adm.acquire("late", deadline=0.0)
        except Rej as e:
            out.append(e.reason)
        for _ in range(8):
            adm.release()
            await asyncio.sleep(0)
        await asyncio.gather(*tasks)
        out.append(grants)
        adm2 = M.admission.AdmissionController(M.admission.AdmissionConfig(
            max_concurrent=1, max_queue=1, queue_wait_slo_s=0.05))
        await adm2.acquire("x")
        res = await asyncio.gather(adm2.acquire("y"), adm2.acquire("z"),
                                   return_exceptions=True)
        out.append([r.reason if isinstance(r, Rej) else r for r in res])
        st = adm2.stats()
        st.pop("queue_wait_p99_s")
        out.append(st)
        return out

    return asyncio.run(main())


def case_autoscaler(M, mp):
    A, FM = M.autoscaler.FleetAutoscaler, M.autoscaler.FleetMetrics
    cfg = M.autoscaler.AutoscaleConfig
    out = []
    a = A(cfg(min_replicas=1, max_replicas=3, upscale_delay_s=3.0,
              downscale_delay_s=10.0, ttft_high_ms=1000.0,
              occupancy_low=0.3, queue_wait_low_ms=50.0))
    hot = FM(ttft_ms=5000.0, chips_per_slice=1)
    idle = FM(ttft_ms=5.0, queue_wait_ms=1.0, occupancy=0.05)
    mid = FM(ttft_ms=5.0, queue_wait_ms=1.0, occupancy=0.6)
    seq = [(hot, 1, 100.0), (hot, 1, 101.0), (hot, 1, 103.5),
           (mid, 2, 104.0), (hot, 2, 105.0), (hot, 2, 109.0),
           (hot, 3, 120.0), (idle, 3, 121.0), (idle, 3, 125.0),
           (mid, 3, 126.0), (idle, 3, 127.0), (idle, 3, 138.0),
           (idle, 2, 150.0), (idle, 2, 161.0), (idle, 1, 200.0),
           (FM(shed_delta=3), 1, 201.0), (FM(shed_delta=3), 1, 205.0),
           (FM(slo_page=True), 2, 206.0), (FM(slo_page=True), 2, 210.0),
           (FM(page_pressure=1.5), 2, 211.0),
           (FM(page_pressure=1.5), 2, 215.0),
           (FM(ttft_ms=5000.0, chips_per_slice=2), 2, 300.0),
           (FM(ttft_ms=5000.0, chips_per_slice=2), 2, 304.0)]
    for m, active, now in seq:
        out.append(a.decide(m, active=active, now=now))
        out.append(dict(a.last_decision or {}))
    assert {1, 2, 3} <= {o for o in out if isinstance(o, int)}
    return out


def case_watchdog(M, mp):
    rec = M.telemetry.FlightRecorder()
    clock = Clock(0.0)
    wd = M.watchdog.SLOBurnWatchdog(M.watchdog.WatchdogConfig(
        short_window_s=10.0, long_window_s=60.0, page_burn_rate=2.0,
        warn_burn_rate=1.0, objective=0.9, page_pressure_high=0.9,
        anomaly_rate_high=0.25, anomaly_rate_warn=0.1, anomaly_count=2),
        recorder=rec, clock=clock)
    tot = {k: 0.0 for k in ("ttft_n", "ttft_bad", "queue_n",
                            "queue_bad", "e2e_n", "e2e_bad")}
    out = []
    # healthy, then a burst of bad TTFTs, then recovery, then idle
    phases = [(20, 0)] * 4 + [(20, 12)] * 8 + [(20, 0)] * 10 + [(0, 0)] * 8
    for i, (n, bad) in enumerate(phases):
        clock.t += 5.0
        for key in ("ttft", "queue", "e2e"):
            tot[f"{key}_n"] += n
        tot["ttft_bad"] += bad
        tot["e2e_bad"] += bad // 2
        rep = wd.observe(dict(tot), idle=(n == 0))
        out.append([wd.paging, dict(wd.state), round(wd.max_burn, 9),
                    json.loads(json.dumps(rep, sort_keys=True))])
    for p in (0.5, 0.95, 0.97, 0.85, 0.3):
        out.append([wd.observe_pressure(p), wd.pressure_state])
    for r in (0.3, 0.4, 0.15, 0.05):
        out.append([wd.observe_anomaly(r), wd.anomaly_state])
    out.append(wd.alerts_total)
    out.append(_events(rec))
    assert any(o[0] for o in out[:len(phases)] if isinstance(o, list))
    return out


def case_breaker(M, mp):
    cfg = M.failover.HealthConfig(probe_failures=3, open_cooldown_s=2.0,
                                  half_open_probes=2,
                                  cooldown_backoff=2.0,
                                  max_cooldown_s=10.0)
    b = M.failover.CircuitBreaker(cfg)
    out = []
    now = 100.0
    script = ["f", "s", "f", "f", "f", "probe", "f", "probe", "s",
              "s", "hard", "probe", "s", "s", "probe", "s", "f", "f"]
    for step in script:
        now += 1.5
        if step == "probe":
            out.append(("probe", b.should_probe(now)))
        elif step == "s":
            out.append(("success", b.record_success(now)))
        else:
            b.record_failure(now, hard=step == "hard")
        out.append((b.state, b.gauge(), round(b.cooldown_s(), 9),
                    b.stats()))
    assert {"closed", "open", "half_open"} <= {o[0] for o in out}
    return out


def case_transcript_and_sse(M, mp):
    F = M.failover
    tr = F.StreamTranscript()
    chunks = [{"i": 0, "toks": [5, 6], "text": "ab"},
              {"i": 2, "toks": [7], "text": "c"},
              {"i": 0, "toks": [5, 6, 7], "text": "abc"},      # replay
              {"i": 2, "toks": [7, 8], "text": "cd"},          # overlap
              {"i": 4, "toks": [], "text": "", "finished": True,
               "reason": "length"}]
    out = [tr.fold(c) for c in chunks]
    out.append([tr.tokens, tr.finished, tr.reason])
    body = {"prompt": "p", "max_tokens": 9, "seed": 11,
            "_deadline_epoch": 5.0, "_request_id": "abc"}
    tr2 = F.StreamTranscript()
    tr2.fold({"i": 0, "toks": [1, 2, 3], "text": "xyz"})
    out.append(F.continuation_body(body, tr2))
    out.append(F.continuation_body({"prompt": "q"}, tr2))
    b = {"prompt": "p", "_request_id": "0123456789abcdef"}
    F.pin_stream_identity(b)
    out.append(b)
    for chat in (False, True):
        for text, fin, reason in (("hi", False, None), ("", True, "stop"),
                                  ("x", True, "length")):
            out.append(F.sse_chunk(chat, "cmpl-1", "m", 1700000000, text,
                                   fin, reason, [1, 2]))
    out.append([F.is_request_fault(e) for e in (
        ValueError("x"), TypeError("y"), RuntimeError("z"),
        asyncio.TimeoutError(), F.StreamBroken("b"),
        F.StreamStalled("s"))])
    out.append(sorted(F.TOKEN_STREAM_METHODS.items()))
    return out


def case_chaos_schedule(M, mp):
    C = M.chaos
    s = C.ChaosSchedule(seed=7)
    s.sever_stream(after_chunks=3, method="completions_stream_tokens")
    s.fail_calls(method="completions", at_call=1, count=2)
    s.timeout_probes(at_call=2, count=2)
    s.stall_stream(after_chunks=5, at_call=1)
    s.slow_calls(0.25, method="chat", count=1)
    calls = [("fleet_stats", False)] * 5 + [
        ("completions", False)] * 4 + [
        ("completions_stream_tokens", True)] * 3 + [
        ("chat", False), ("chat_stream_tokens", True)]
    out = []
    for method, stream in calls:
        f = s.take(method, is_stream=stream)
        out.append(None if f is None else dataclasses.asdict(f))
    r = C.ChaosSchedule(seed=3).random_failures(p_call_error=0.3,
                                                p_sever=0.4)
    for i in range(40):
        f = r.take("completions" if i % 2 else "completions_stream_tokens",
                   is_stream=bool(i % 2 == 0))
        out.append(None if f is None else dataclasses.asdict(f))
    out.append([s.fired, s.stats(), r.stats()])
    assert any(o is not None for o in out[:len(calls)])
    return out


def _pin_tracing(M, mp):
    """Pin the process wall anchor both tracing modules render with."""
    tr = M.tracemerge.tracing
    mp.setattr(tr, "mono_to_epoch", lambda m: 1.7e9 + m)
    mp.setattr(tr, "wall_anchor", lambda: 1.7e9)
    mp.setattr(M.tracemerge.os, "getpid", lambda: 4242)


def case_tracemerge(M, mp):
    _pin_tracing(M, mp)
    T = M.tracemerge
    buf = T.IngressTraceBuffer(capacity=16)
    trace = {"trace_id": "t1", "span_id": "s1", "flow_id": "f1"}
    buf.add(*T.request_events(buf.next_tid(), "rq1", trace, 10.0, 10.5,
                              10.6, 12.0, "r0", "affinity",
                              "completions", "", "ok"))
    buf.add(*T.request_events(buf.next_tid(), "rq2",
                              {"trace_id": "t2", "span_id": "s2",
                               "flow_id": "f2"}, 11.0, None, None,
                              11.5, None, None, "chat_stream", "acme",
                              "rejected:queue_full"))
    shared = [{"ph": "X", "name": "decode", "ts": 1.0, "dur": 2.0,
               "pid": 1, "tid": 1, "args": {"request_id": "rq1",
                                            "trace_id": "t1"}},
              {"ph": "X", "name": "prefill", "ts": 0.5, "dur": 0.5,
               "pid": 1, "tid": 2, "args": {"request_id": "rq3"}}]
    docs = {"r0": {"traceEvents": shared, "metadata": {"pid": 1}},
            "r1": {"traceEvents": list(shared), "metadata": {"pid": 1}},
            "r2": {"error": "TimeoutError()"},
            "r3": RuntimeError("down")}
    out = [buf.stats(), buf.events()]
    out.append(T.merge_fleet_traces(docs, buf))
    out.append(T.merge_fleet_traces(docs, buf, request_id="rq1"))
    out.append(T.merge_fleet_traces(docs, None, trace_id="t2"))
    out.append(T.filter_trace(buf.events(), request_id="rq2"))
    evs = {"r0": [{"seq": 1, "ts": 5.0, "event": "admit",
                   "request_id": "rq1"},
                  {"seq": 2, "ts": 7.0, "event": "finish",
                   "request_id": "rq1"}],
           "r1": [{"seq": 1, "ts": 6.0, "event": "admit",
                   "request_id": "rq2"}]}
    ingress = [{"seq": 1, "ts": 5.5, "event": "failover",
                "request_id": "rq1"}]
    out.append(T.merge_flight_recorders(evs, ingress))
    out.append(T.merge_flight_recorders(evs, ingress, request_id="rq1"))
    return json.loads(json.dumps(out))


def _capture(M, mp):
    _pin_tracing(M, mp)
    L = M.trafficlog
    seq = iter(range(10 ** 6))
    mp.setattr(L.uuid, "uuid4",
               lambda: types.SimpleNamespace(hex=f"{next(seq):032x}"))
    clock = Clock(50.0)
    rec = L.TrafficRecorder(capacity=4, model_id="m", clock=clock)
    out = [rec.record(method="completions", note="before capture")]
    out.append(rec.start_capture(note="scripted"))
    for i in range(6):
        clock.t += 0.25
        rec.observe_request({
            "rid": f"r{i}", "method": "completions_stream" if i % 2
            else "completions", "stream": bool(i % 2),
            "tenant": "acme" if i % 3 == 0 else "", "lane": "interactive",
            "fp": f"{i:016x}", "prompt_tokens": 10 + i,
            "out_tokens": 3 * i, "params": L.sampling_brief(
                {"max_tokens": 8, "temperature": 0.5, "top_p": True,
                 "prompt": "secret", "seed": i}),
            "deadline_s": 2.0 if i == 4 else None, "status": "ok",
            "finish": "length", "outcome": "affinity",
            "replica": f"r{i % 2}", "failovers": i // 4,
            "t0": clock.t - 0.2,
            "t_first": clock.t - 0.1 if i else None})
        if i == 2:
            out.append(rec.mark("half way"))
    out.append(rec.stop_capture())
    blob = rec.export()
    out += [blob, rec.tail(3), rec.tail(8, since=4), rec.stats()]
    out.append(L.decode_capture(blob))
    assert "secret" not in blob
    lines = blob.splitlines()
    corrupt = {
        "truncated": "\n".join(lines[:-1]),
        "short": "\n".join(lines[:3] + lines[-1:]),
        "crc": blob.replace('"prompt_tokens":11', '"prompt_tokens":12'),
        "magic": blob.replace("RTTC1", "XXXX1", 1),
        "version": blob.replace("RTTC1", "RTTC9", 1),
        "malformed": "RTTC1 deadbeef",
        "empty": "",
        "json": lines[0].split(" ")[0] + " " + L._crc(b"{x") + " {x",
        "headless": "\n".join(lines[1:]),
        "binary": b"\xff\xfe",
    }
    for name, bad in corrupt.items():
        try:
            L.decode_capture(bad)
            out.append((name, None))
        except L.CaptureError as e:
            out.append((name, type(e).__name__, str(e)))
    return out


def case_trafficlog(M, mp):
    out = _capture(M, mp)
    assert all(o[1] is not None for o in out if isinstance(o, tuple))
    return out


def case_prefix_store(M, mp):
    store = M.kvt.FleetPrefixStore(capacity_bytes=100)
    out = []
    for i, (fp, size) in enumerate([("a", 30), ("b", 30), ("c", 30)]):
        out.append(store.put(fp, "x" * size, tokens=16 * (i + 1),
                             publisher=f"r{i % 2}") is not None)
    for fp in ("a", "a", "c", "zz"):
        out.append(store.get(fp) is not None)
    out.append(store.put("d", "y" * 30, tokens=8, publisher="r1")
               is not None)                         # evicts b (0 hits)
    out.append(sorted(store._entries))
    out.append(store.put("e", "z" * 60, tokens=8, publisher="r0")
               is not None)                         # evicts d, then c
    out.append(sorted(store._entries))
    out.append(store.put("huge", "h" * 101, tokens=8, publisher="r0"))
    out.append(store.put("a", "other", tokens=1, publisher="r1").nbytes)
    out.append(store.stats())
    body = {"messages": [{"role": "user", "content": "hello"},
                         {"role": "assistant", "content": "hi"}]}
    out.append([M.kvt.prompt_char_len(b) for b in (
        {"prompt": "abc"}, {"prompt": 12345}, body, {})])
    out.append([M.kvt.REPLICA_ROLES, M.kvt.ROLE_PREFILL,
                M.kvt.ROLE_DECODE, M.kvt.ROLE_MIXED])
    out.append(dataclasses.asdict(M.kvt.TransportConfig()))
    return out


def _family(m):
    info = m.info
    return {"type": m.metric_type, "name": info["name"],
            "description": info["description"],
            "tag_keys": list(info["tag_keys"]),
            "boundaries": list(getattr(m, "boundaries", []) or [])}


def case_metric_families(M, mp):
    wd = M.watchdog.SLOBurnWatchdog(M.watchdog.WatchdogConfig())
    fams = {**{f"fleet.{k}": v
               for k, v in M.failover.fleet_metrics().items()},
            **{f"transport.{k}": v
               for k, v in M.kvt.transport_metrics().items()},
            **{f"admission.{k}": v
               for k, v in M.admission.admission_metrics().items()},
            **{f"traffic.{k}": v
               for k, v in M.trafficlog.traffic_metrics().items()},
            "watchdog.burn": wd._burn_gauge, "watchdog.alerts": wd._alerts,
            "watchdog.pressure": wd._pressure_gauge,
            "watchdog.anomaly": wd._anomaly_gauge}
    out = {k: _family(v) for k, v in sorted(fams.items())}
    out["INTERNAL_BODY_KEYS"] = list(M.server.INTERNAL_BODY_KEYS)
    return out


CASES = {f.__name__[len("case_"):]: f for f in (
    case_fingerprints, case_snapshot_from_stats, case_router_sequence,
    case_admission_sync, case_admission_async, case_autoscaler,
    case_watchdog, case_breaker, case_transcript_and_sse,
    case_chaos_schedule, case_tracemerge, case_trafficlog,
    case_prefix_store, case_metric_families)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_decides_as_jax(case, monkeypatch):
    want = CASES[case](JAX, monkeypatch)
    got = CASES[case](PORT, monkeypatch)
    assert got == want


def test_capture_bytes_equal_jax(monkeypatch):
    """A capture of the same events is the same bytes, and each
    package's decoder reads the other's."""
    blob_j, blob_t = (next(o for o in _capture(M, monkeypatch)
                           if isinstance(o, str)) for M in (JAX, PORT))
    assert blob_t.startswith("RTTC1 ") and blob_t == blob_j
    assert t_trafficlog.decode_capture(blob_j) == \
        j_trafficlog.decode_capture(blob_t)
