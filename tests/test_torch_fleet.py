"""ray_tpu_torch's serving fleet end to end, on two port replicas.

Two port `LLMServerImpl` replicas serve the float32 debug model on the
CPU (`device="cpu"`, `async_readback=False`) from one module-scoped
fixture, behind the port's `FleetManager`; their tokens are held to
the JAX gather engine (`decode_impl="gather"`, `async_readback=False`)
serving the same numpy weights, as `tests/test_torch_server.py` does.
The cases mirror the JAX fleet's own e2e tests with a port replica in
place of each JAX one: prefix affinity and its cache hits, overload
429s, deadline propagation, mid-stream failover (greedy and sampled),
scale-down drain, disaggregated prefill (exact, short-prompt skip,
prefill failure), drain migration, the severed-ship and corrupted-ship
fallbacks to replay, failover-by-restore, the prefix store, breaker
eviction and re-admission, the last active replica, the status and
metrics surfaces, and a hung replica caught by the stall watchdog with
a short explicit timeout. Each test bounds its own event loop run.
"""

import asyncio
import base64
import json
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal.server import LLMServerImpl as JaxServer
from ray_tpu.models import llama as jl
from ray_tpu_torch import LLMConfig, LLMServerImpl
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm import (AdmissionConfig, AdmissionRejected,
                                     AutoscaleConfig, ChaosReplicaClient,
                                     ChaosSchedule, FleetManager,
                                     HealthConfig, LocalReplicaClient,
                                     RouterConfig, TransportConfig,
                                     prefix_fingerprint)
from ray_tpu_torch.serve.llm.fleet import (ACTIVE, DRAINING, STANDBY,
                                           UNHEALTHY)

torch.set_num_threads(1)

KW = dict(max_batch_size=4, page_size=8, num_pages=128, seed=7,
          max_seq_len=1024, max_prefill_tokens=32, async_readback=False,
          enable_kv_offload=True)
# greedy continuations of these prompts run 300 tokens without EOS on
# the fixture's weights (the drain and deadline cases need live streams)
LONG = ("fleet stream probe 1", "fleet stream probe 2",
        "fleet stream probe 5", "corrupted cargo scenario",
        "wedged replica restore scenario")

_state = {}


def _run(coro, limit_s):
    """One test's event loop, bounded."""
    return asyncio.run(asyncio.wait_for(coro, limit_s))


@pytest.fixture(scope="module")
def world():
    """(JAX oracle server, {rid: port server}, metrics tag)."""
    if "servers" not in _state:
        tag = f"tfleet{uuid.uuid4().hex[:8]}"
        oracle = JaxServer({
            "model_id": "m",
            "model_source": jl.config("debug", dtype=jnp.float32),
            "engine_kwargs": dict(KW, decode_impl="gather",
                                  prefill_buckets=(16, 32, 64))})
        params = jax.tree_util.tree_map(np.asarray, oracle.engine.params)
        servers = {}
        cfg = tl.config("debug", dtype=torch.float32)
        for rid in ("r0", "r1"):
            eng = te.InferenceEngine(te.EngineConfig(
                model=cfg, device="cpu", metrics_model_id=tag,
                metrics_replica_id=rid, **KW), params=params)
            servers[rid] = LLMServerImpl(
                LLMConfig(model_id="m", model_source=cfg).to_dict(),
                engine=eng)
        _state.update(oracle=oracle, servers=servers, tag=tag)
    return _state["oracle"], _state["servers"], _state["tag"]


def _cancel_pumps(servers):
    """The pumps belong to the test's loop: cancel them before it
    closes (each test's first request starts them anew)."""
    for srv in servers.values():
        if srv._pump is not None:
            srv._pump.cancel()


def _oracle(oracle, body):
    """The JAX gather engine's token ids for one stream body."""
    async def main():
        out = [c async for c in oracle.completions_stream_tokens(
            dict(body))]
        oracle._pump.cancel()
        return [t for c in out for t in c["toks"]]
    return _run(main(), 120)


def _fleet(servers, clients=None, **over):
    kw = dict(
        router=RouterConfig(prefix_depth=64, spill_waiting=16),
        admission=AdmissionConfig(max_concurrent=8, max_queue=16,
                                  queue_wait_slo_s=30.0),
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=2),
        drain_timeout_s=10.0, model_id="m")
    kw.update(over)
    return FleetManager(
        clients if clients is not None else
        [LocalReplicaClient(rid, srv) for rid, srv in servers.items()],
        **kw)


def _chaos_clients(servers, schedules):
    return [ChaosReplicaClient(LocalReplicaClient(rid, srv),
                               schedules[rid])
            for rid, srv in servers.items()]


def _sse_transcript(chunks):
    """Fleet SSE chunks -> (token ids, text, finish reason); exactly
    one finish."""
    toks, text, reasons = [], "", []
    for c in chunks:
        payload = c[len("data: "):].strip()
        if payload == "[DONE]":
            continue
        ch = json.loads(payload)["choices"][0]
        toks += ch.get("token_ids") or []
        text += ch.get("text") or ch.get("delta", {}).get("content") or ""
        if ch["finish_reason"] is not None:
            reasons.append(ch["finish_reason"])
    assert len(reasons) == 1, reasons
    return toks, text, reasons[0]


def _stream(fleet, servers, body, on_chunk=None, limit_s=60):
    async def main():
        chunks = []
        async for c in fleet.dispatch_stream("completions_stream",
                                             dict(body)):
            chunks.append(c)
            if on_chunk is not None:
                await on_chunk(len(chunks))
        _cancel_pumps(servers)
        return chunks
    return _run(main(), limit_s)


def _prompt_routed_to(fleet, rid, salt):
    i = 0
    while True:
        p = f"chaos stream probe {salt}{i}"
        if fleet.router.ring.preferred(
                prefix_fingerprint({"prompt": p}, 64))[0] == rid:
            return p
        i += 1


def _events(fleet):
    return [e["event"] for e in fleet.recorder.events()]


def _total(metric, **tags):
    return sum(v for t, v in metric._samples()
               if all(t.get(k) == w for k, w in tags.items()))


# ----------------------------------------------------- routing, admission

_PREFIX_A = ("alpha context block that the whole tenant shares "
             + "a" * 14)[:64]
_PREFIX_B = ("bravo context block that another tenant shares "
             + "b" * 16)[:64]


def test_e2e_prefix_affinity_colocates_and_hits_cache(world):
    oracle, servers, _ = world
    fleet = _fleet(servers)
    bodies = [{"prompt": p + f" req {i}", "max_tokens": 4}
              for p in (_PREFIX_A, _PREFIX_B) for i in range(3)]
    hit0 = {rid: srv.engine.allocator.cache_hit_rate
            for rid, srv in servers.items()}

    async def main():
        picked, outs = [], []
        for b in bodies:
            before = {r: st.requests_total
                      for r, st in fleet.replicas.items()}
            outs.append(await fleet.dispatch("completions", dict(b)))
            picked.append({r for r, st in fleet.replicas.items()
                           if st.requests_total != before[r]})
        _cancel_pumps(servers)
        return picked, outs

    picked, outs = _run(main(), 60)
    a = set().union(*picked[:3])
    b = set().union(*picked[3:])
    assert len(a) == 1 and len(b) == 1, (a, b)
    st = fleet.router.stats()
    assert st["picks"] == 6 and st["affinity_hits"] == 6
    for rid in a | b:
        assert servers[rid].engine.allocator.cache_hit_rate > \
            hit0[rid], f"no prefix-cache hits on affine replica {rid}"
    tok = servers["r0"].tokenizer
    for body, out in zip(bodies, outs):
        assert out["choices"][0]["text"] == tok.decode(
            _oracle(oracle, body))


def test_e2e_overload_429_with_bounded_wait(world):
    _, servers, _ = world
    fleet = _fleet(servers, admission=AdmissionConfig(
        max_concurrent=1, max_queue=1, queue_wait_slo_s=8.0))

    async def main():
        res = await asyncio.gather(
            *(fleet.dispatch("completions",
                             {"prompt": f"overload probe {i}",
                              "max_tokens": 2}) for i in range(16)),
            return_exceptions=True)
        _cancel_pumps(servers)
        return res

    t0 = time.monotonic()
    res = _run(main(), 60)
    ok = [r for r in res if isinstance(r, dict)]
    rejected = [r for r in res if isinstance(r, AdmissionRejected)]
    assert len(ok) + len(rejected) == 16
    assert len(rejected) >= 10 and len(ok) >= 1
    assert all(r.retry_after_s > 0 for r in rejected)
    adm = fleet.admission.stats()
    assert adm["rejected"]["queue_full"] >= 10
    assert adm["queue_wait_p99_s"] <= 8.5
    assert time.monotonic() - t0 < 60.0


def test_e2e_deadline_propagation_through_fleet(world):
    _, servers, _ = world
    fleet = _fleet(servers)
    sheds = fleet.metrics["deadline_sheds"]
    adm0 = _total(sheds, stage="admission")
    eng0 = _total(sheds, stage="engine")
    body = {"prompt": LONG[0], "max_tokens": 300, "deadline_s": 0.2}

    async def main():
        with pytest.raises(AdmissionRejected) as ei:
            await fleet.dispatch("completions",
                                 {"prompt": "already dead",
                                  "max_tokens": 2, "deadline_s": -1.0})
        assert ei.value.reason == "deadline"
        chunks = [c async for c in fleet.dispatch_stream(
            "completions_stream", dict(body))]
        out = await fleet.dispatch("completions", dict(body))
        _cancel_pumps(servers)
        return chunks, out

    chunks, out = _run(main(), 60)
    toks, _, reason = _sse_transcript(chunks)
    assert reason == "deadline" and len(toks) < 300
    assert out["choices"][0]["finish_reason"] == "deadline"
    assert _total(sheds, stage="admission") == adm0 + 1
    assert _total(sheds, stage="engine") >= eng0 + 2
    kinds = [e["event"] for srv in servers.values()
             for e in srv.engine.telemetry.recorder.events()]
    assert "deadline_abort" in kinds


# ------------------------------------------------------------ failover

@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_e2e_mid_stream_failover_token_exact(world, sampled):
    oracle, servers, _ = world
    victim = "r0"
    schedules = {rid: ChaosSchedule(seed=11) for rid in servers}
    schedules[victim].sever_stream(after_chunks=2,
                                   method="completions_stream_tokens")
    fleet = _fleet(servers, clients=_chaos_clients(servers, schedules),
                   router=RouterConfig(prefix_depth=64, spill_waiting=64),
                   health=HealthConfig(open_cooldown_s=30.0))
    body = {"prompt": _prompt_routed_to(fleet, victim,
                                        "S" if sampled else "G"),
            "max_tokens": 12}
    if sampled:
        body.update(temperature=0.8, top_p=0.9, seed=4242)
    fo0 = _total(fleet.metrics["failovers"])

    async def main():
        chunks = [c async for c in fleet.dispatch_stream(
            "completions_stream", dict(body))]
        out = await fleet.dispatch("completions",
                                   {"prompt": "after failover",
                                    "max_tokens": 2})
        assert out["choices"][0]["finish_reason"] is not None
        _cancel_pumps(servers)
        return chunks

    toks, _, reason = _sse_transcript(_run(main(), 60))
    assert reason in ("length", "stop")
    assert [f["kind"] for f in schedules[victim].fired] == \
        ["stream_sever"]
    assert fleet.replicas[victim].status == UNHEALTHY
    assert fleet.router.ring.nodes() == ["r1"]
    assert {"failover", "replica_evicted"} <= set(_events(fleet))
    assert _total(fleet.metrics["failovers"]) == fo0 + 1
    want = _oracle(oracle, body)
    assert len(want) == 12 and toks == want


def test_e2e_hung_replica_stall_watchdog_fails_over(world):
    """A replica that hangs mid-stream (no raise, no end) is caught by
    the relay's stall watchdog; its timeout is short and explicit, and
    the survivor's first chunk comes within it on the CPU."""
    oracle, servers, _ = world
    victim = "r1"
    schedules = {rid: ChaosSchedule() for rid in servers}
    schedules[victim].stall_stream(after_chunks=2,
                                   method="completions_stream_tokens")
    fleet = _fleet(servers, clients=_chaos_clients(servers, schedules),
                   router=RouterConfig(prefix_depth=64, spill_waiting=64),
                   health=HealthConfig(stream_stall_timeout_s=1.5,
                                       open_cooldown_s=300.0))
    body = {"prompt": _prompt_routed_to(fleet, victim, "H"),
            "max_tokens": 10}
    toks, _, reason = _sse_transcript(_stream(fleet, servers, body))
    assert reason in ("length", "stop") and len(toks) == 10
    assert [f["kind"] for f in schedules[victim].fired] == \
        ["stream_stall"]
    assert fleet.replicas[victim].status == UNHEALTHY
    fo = next(e for e in fleet.recorder.events()
              if e["event"] == "failover")
    assert "StreamStalled" in fo["error"]
    assert toks == _oracle(oracle, body)


def test_e2e_scale_down_drains_streams_token_exact(world):
    oracle, servers, _ = world
    fleet = _fleet(servers)
    by_rid = {rid: [] for rid in fleet.replicas}
    i = 0
    while any(len(v) < 2 for v in by_rid.values()):
        p = f"drain stream probe {i}"
        rid = fleet.router.ring.preferred(
            prefix_fingerprint({"prompt": p}, 64))[0]
        if len(by_rid[rid]) < 2:
            by_rid[rid].append(p)
        i += 1
    bodies = [{"prompt": p, "max_tokens": 12}
              for group in by_rid.values() for p in group]

    async def consume(body, started):
        chunks = []
        async for c in fleet.dispatch_stream("completions_stream", body):
            chunks.append(c)
            if len(chunks) == 1:
                started.set_result(None)
        return chunks

    async def main():
        loop = asyncio.get_running_loop()
        started = [loop.create_future() for _ in bodies]
        tasks = [asyncio.create_task(consume(dict(b), s))
                 for b, s in zip(bodies, started)]
        await asyncio.gather(*started)
        fleet._apply_target(1)
        draining = [r for r, st in fleet.replicas.items()
                    if st.status == DRAINING]
        assert len(draining) == 1
        chunks = await asyncio.gather(*tasks)
        out = await fleet.dispatch("completions",
                                   {"prompt": "after drain",
                                    "max_tokens": 2})
        assert out["choices"][0]["finish_reason"] is not None
        await fleet.replicas[draining[0]].drain_task
        _cancel_pumps(servers)
        return draining[0], chunks

    victim, all_chunks = _run(main(), 60)
    assert fleet.replicas[victim].status == STANDBY
    done = [e for e in fleet._scale_events if e["event"] == "drain_done"]
    assert done and done[-1]["clean"] is True
    for body, chunks in zip(bodies, all_chunks):
        assert _sse_transcript(chunks)[0] == _oracle(oracle, body)


# --------------------------------------------- the KV transport: disagg

def _transport(**kw):
    return TransportConfig(**{"enable_disagg": False,
                              "enable_prefix_store": False, **kw})


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_e2e_disagg_prefill_on_a_decode_on_b_token_exact(world, sampled):
    oracle, servers, _ = world
    body = {"prompt": "long shared context " * 16, "max_tokens": 16}
    if sampled:
        body.update(temperature=0.8, top_p=0.9, seed=20124)
    fleet = _fleet(servers, roles=["prefill", "decode"],
                   transport=_transport(enable_disagg=True,
                                        disagg_prompt_chars=64))
    assert fleet.router.ring.nodes() == ["r1"]
    exports0 = servers["r0"].engine.host_tier.exports_total
    restores0 = servers["r1"].engine.host_tier.restores_total
    toks, _, reason = _sse_transcript(_stream(fleet, servers, body))
    assert reason in ("length", "stop")
    want = _oracle(oracle, body)
    assert len(want) == 16 and toks == want
    assert servers["r0"].engine.host_tier.exports_total == exports0 + 1
    assert servers["r1"].engine.host_tier.restores_total == \
        restores0 + 1
    assert "disagg_handoff" in _events(fleet)
    assert "disagg_prefill" in {e.get("name")
                                for e in fleet.trace.events()}


def test_e2e_disagg_short_prompt_skips_handoff(world):
    oracle, servers, _ = world
    fleet = _fleet(servers, roles=["prefill", "decode"],
                   transport=_transport(enable_disagg=True,
                                        disagg_prompt_chars=256))
    exports0 = servers["r0"].engine.host_tier.exports_total
    body = {"prompt": "short", "max_tokens": 4}
    toks, _, _ = _sse_transcript(_stream(fleet, servers, body))
    assert toks == _oracle(oracle, body)
    assert servers["r0"].engine.host_tier.exports_total == exports0
    assert "disagg_handoff" not in _events(fleet)


def test_e2e_disagg_prefill_failure_falls_back(world):
    oracle, servers, _ = world
    schedules = {rid: ChaosSchedule() for rid in servers}
    schedules["r0"].fail_calls(method="prefill_export", count=-1)
    fleet = _fleet(servers, clients=_chaos_clients(servers, schedules),
                   roles=["prefill", "decode"],
                   transport=_transport(enable_disagg=True,
                                        disagg_prompt_chars=64))
    body = {"prompt": "fall back to mixed prefill " * 8, "max_tokens": 8}
    toks, _, _ = _sse_transcript(_stream(fleet, servers, body))
    assert toks == _oracle(oracle, body)
    assert [f["kind"] for f in schedules["r0"].fired] == ["call_error"]
    assert "disagg_fallback" in _events(fleet)


# ------------------------------------ the KV transport: migration, restore

def _drain_on_chunk(fleet, st, at=3):
    async def on_chunk(n):
        if n == at:
            _, info = next(iter(fleet._live_streams.items()))
            st["victim"] = info["replica"]
            fleet._begin_drain(st["victim"])
        await asyncio.sleep(0)
    return on_chunk


def test_e2e_drain_migration_ships_session_token_exact(world):
    oracle, servers, _ = world
    body = {"prompt": LONG[1], "max_tokens": 300}
    fleet = _fleet(servers, transport=_transport())
    st = {}

    async def main():
        chunks = []
        on_chunk = _drain_on_chunk(fleet, st)
        async for c in fleet.dispatch_stream("completions_stream",
                                             dict(body)):
            chunks.append(c)
            await on_chunk(len(chunks))
        for _ in range(500):
            if fleet.replicas[st["victim"]].status == STANDBY:
                break
            await asyncio.sleep(0.02)
        _cancel_pumps(servers)
        return chunks

    toks, _, reason = _sse_transcript(_run(main(), 60))
    assert reason == "length" and len(toks) == 300
    assert toks == _oracle(oracle, body)
    assert "session_migrated" in _events(fleet)
    assert "session_migration" in {e.get("name")
                                   for e in fleet.trace.events()}
    assert _total(fleet.kvt_metrics["sessions_shipped"],
                  kind="migration") >= 1
    assert fleet.replicas[st["victim"]].status == STANDBY


def test_e2e_migration_severed_mid_ship_replays_token_exact(world):
    oracle, servers, _ = world
    body = {"prompt": "sever the ship mid migration", "max_tokens": 14,
            "temperature": 0.8, "top_p": 0.9, "seed": 777}
    victim = _fleet(servers).router.pick(prefix_fingerprint(body, 64),
                                         {}, {})
    schedules = {rid: ChaosSchedule() for rid in servers}
    schedules[victim].sever_stream(after_chunks=2)
    schedules[victim].fail_calls(method="export_session", count=-1)
    fleet = _fleet(servers, clients=_chaos_clients(servers, schedules),
                   transport=_transport())
    toks, _, _ = _sse_transcript(_stream(fleet, servers, body))
    assert toks == _oracle(oracle, body) and len(toks) == 14
    kinds = [f["kind"] for f in schedules[victim].fired]
    assert "stream_sever" in kinds and "call_error" in kinds
    evs = _events(fleet)
    assert "failover" in evs and "failover_restore" not in evs


class _CorruptingClient:
    """Flips one payload byte in every export_session response."""

    def __init__(self, inner):
        self.inner = inner
        self.replica_id = inner.replica_id
        self.shares_registry = inner.shares_registry

    async def call(self, method, *args):
        out = await self.inner.call(method, *args)
        if method == "export_session" and isinstance(out, dict) \
                and out.get("session"):
            blob = bytearray(base64.b64decode(out["session"]))
            blob[len(blob) // 2] ^= 0xFF
            out = dict(out, session=base64.b64encode(bytes(blob))
                       .decode("ascii"))
        return out

    def stream(self, method, body):
        return self.inner.stream(method, body)


def test_e2e_corrupted_ship_falls_back_to_replay(world):
    oracle, servers, _ = world
    body = {"prompt": LONG[3], "max_tokens": 300}
    fleet = _fleet(servers, transport=_transport(), clients=[
        _CorruptingClient(LocalReplicaClient(rid, srv))
        for rid, srv in servers.items()])
    st = {}
    chunks = _stream(fleet, servers, body, _drain_on_chunk(fleet, st))
    toks, _, reason = _sse_transcript(chunks)
    assert reason == "length" and len(toks) == 300
    assert toks == _oracle(oracle, body)
    evs = _events(fleet)
    assert "session_migrated" in evs and "kv_resume_failed" in evs
    after = _fleet(servers)

    async def main():
        out = await after.dispatch("completions",
                                   {"prompt": "after the storm",
                                    "max_tokens": 2})
        _cancel_pumps(servers)
        return out
    assert _run(main(), 30)["choices"][0]["finish_reason"]


def test_e2e_failover_by_restore_wedged_replica(world):
    """The serving replica wedges (its pump dies) with the session
    parked in its host tier: the stall watchdog fires and the fleet
    exports the parked pages instead of replaying the transcript."""
    oracle, servers, _ = world
    body = {"prompt": LONG[4], "max_tokens": 300}
    fleet = _fleet(servers, transport=_transport(),
                   health=HealthConfig(stream_stall_timeout_s=1.5))
    st = {}

    async def on_chunk(n):
        if n == 1:
            srid, info = next(iter(fleet._live_streams.items()))
            st["victim"] = info["replica"]
            srv = servers[st["victim"]]
            srv._pump.cancel()
            st["parked"] = await asyncio.get_running_loop() \
                .run_in_executor(None, srv.engine.preempt, srid)

    toks, _, reason = _sse_transcript(
        _stream(fleet, servers, body, on_chunk))
    assert st["parked"], "the victim did not park the session"
    assert reason == "length" and toks == _oracle(oracle, body)
    assert "failover_restore" in _events(fleet)
    assert servers[st["victim"]].engine.host_tier.exports_total >= 1


# ----------------------------------------------------- the prefix store

def test_e2e_prefix_store_seeds_second_replica(world):
    oracle, servers, _ = world
    sys_prompt = (f"shared system prompt {uuid.uuid4().hex[:8]} "
                  + "s" * 64)[:64]
    fleet = _fleet(servers,
                   router=RouterConfig(policy="round_robin",
                                       prefix_depth=64),
                   transport=_transport(enable_prefix_store=True,
                                        prefix_min_chars=64))
    hit0 = {rid: srv.engine.allocator.cache_hit_tokens
            for rid, srv in servers.items()}
    bodies = [{"prompt": sys_prompt + f" user turn {i}", "max_tokens": 6}
              for i in range(2)]

    async def main():
        outs = [await fleet.dispatch("completions", dict(b))
                for b in bodies]
        _cancel_pumps(servers)
        return outs

    outs = _run(main(), 60)
    stats = fleet.prefix_store.stats()
    assert stats["publishes"] == 1 and stats["hits"] == 1
    assert _total(fleet.kvt_metrics["prefix_store_hits"]) >= 1
    deltas = {rid: srv.engine.allocator.cache_hit_tokens - hit0[rid]
              for rid, srv in servers.items()}
    assert any(d >= 64 for d in deltas.values()), deltas
    assert {"prefix_published", "prefix_seeded"} <= set(_events(fleet))
    tok = servers["r0"].tokenizer
    for out, b in zip(outs, bodies):
        assert out["choices"][0]["text"] == tok.decode(_oracle(oracle, b))


# -------------------------------------------- health, status, metrics

def test_e2e_breaker_evicts_on_probe_failures_then_readmits(world):
    _, servers, _ = world
    sched = ChaosSchedule().timeout_probes(count=3)
    schedules = {"r0": ChaosSchedule(), "r1": sched}
    cooldown = 1.0
    fleet = _fleet(servers, clients=_chaos_clients(servers, schedules),
                   health=HealthConfig(probe_failures=3,
                                       open_cooldown_s=cooldown,
                                       half_open_probes=2))
    ev0 = _total(fleet.metrics["evictions"])

    async def main():
        await fleet.refresh()
        await fleet.refresh()
        assert fleet.replicas["r1"].status == ACTIVE
        await fleet.refresh()
        opened = time.monotonic()
        assert fleet.replicas["r1"].status == UNHEALTHY
        assert fleet.router.ring.nodes() == ["r0"]
        calls = sched.stats()["calls"]["fleet_stats"]
        await fleet.refresh()                  # inside the cooldown
        assert sched.stats()["calls"]["fleet_stats"] == calls
        out = await fleet.dispatch("completions",
                                   {"prompt": "while r1 is out",
                                    "max_tokens": 2})
        assert fleet.replicas["r1"].requests_total == 0
        await asyncio.sleep(max(0.0, opened + cooldown + 0.05
                                - time.monotonic()))
        await fleet.refresh()
        assert fleet.replicas["r1"].breaker.state == "half_open"
        await fleet.refresh()
        status = await fleet.status()
        await asyncio.sleep(0)                 # the eviction's dump
        _cancel_pumps(servers)
        return out, status

    out, status = _run(main(), 60)
    assert out["choices"][0]["finish_reason"] is not None
    assert fleet.replicas["r1"].status == ACTIVE
    assert fleet.router.ring.nodes() == ["r0", "r1"]
    assert _total(fleet.metrics["evictions"]) == ev0 + 1
    assert {"replica_evicted", "replica_readmitted"} <= set(
        _events(fleet))
    assert status["replicas"]["r1"]["breaker"]["trips"] == 1


def test_e2e_never_evicts_last_active_replica(world):
    _, servers, _ = world
    sched = ChaosSchedule().timeout_probes(count=1)
    fleet = FleetManager(
        [ChaosReplicaClient(LocalReplicaClient("r0", servers["r0"]),
                            sched)],
        health=HealthConfig(probe_failures=1), model_id="m")

    async def main():
        await fleet.refresh()
        out = await fleet.dispatch("completions",
                                   {"prompt": "still served",
                                    "max_tokens": 2})
        _cancel_pumps(servers)
        return out

    out = _run(main(), 30)
    assert fleet.replicas["r0"].breaker.state == "open"
    assert fleet.replicas["r0"].status == ACTIVE
    assert fleet.router.ring.nodes() == ["r0"]
    assert "eviction_deferred" in _events(fleet)
    assert out["choices"][0]["finish_reason"] is not None


def test_e2e_status_and_metrics_surfaces(world):
    _, servers, tag = world
    fleet = _fleet(servers, roles=["prefill", "decode"],
                   transport=TransportConfig())

    async def main():
        await fleet.dispatch("completions", {"prompt": "surface probe",
                                             "max_tokens": 2})
        await fleet.refresh()
        doc = await fleet.status()
        text = await fleet.metrics_text()
        target = await fleet.autoscale_tick()
        _cancel_pumps(servers)
        return doc, text, target

    doc, text, target = _run(main(), 60)
    for rid in ("r0", "r1"):
        row = doc["replicas"][rid]
        assert row["status"] == ACTIVE and row["chips"] == 1
        assert {"active", "waiting", "kv_occupancy", "free_pages",
                "prefix_cache_hit_rate", "last_tick_age_s", "mfu",
                "kv_host_bytes_used", "snapshot_age_s"} <= set(row)
    assert doc["autoscale"]["active_chips"] == 2
    assert doc["autoscale"]["chips_per_slice"] == 1
    assert doc["transport"]["roles"] == {"r0": "prefill", "r1": "decode"}
    assert doc["replicas"]["r0"]["role"] == "prefill"
    assert doc["transport"]["prefix_store"] is not None
    assert target == 2
    # in-process replicas share the registry: one exposition, each
    # family once, the replicas' series tagged with their ids
    assert f'model="{tag}"' in text
    assert text.count("# TYPE ray_tpu_llm_ttft_seconds histogram") == 1
    for rid in ("r0", "r1"):
        assert f'replica="{rid}"' in text
    for fam in ("ray_tpu_llm_breaker_state", "ray_tpu_llm_fleet_mfu",
                "ray_tpu_llm_slo_burn_rate"):
        assert text.count(f"# TYPE {fam} ") == 1
    plain = _fleet(servers)
    assert _run(plain.status(), 30)["transport"] == {"enabled": False}


# ------------------------------------------- two engines on one card

def test_cuda_engines_share_one_lock_per_device():
    """Engines on one CUDA device take one re-entrant step lock (the
    card runs one tick at a time, and an armed guard steps under the
    lock it holds); CPU engines each keep their own. Built from many
    threads at once, with a short switch interval, every caller of a
    device gets the same lock."""
    import sys
    import threading
    from ray_tpu_torch.llm._internal.engine import make_lock
    dev = torch.device("cuda", 7)
    got, start = [], threading.Barrier(16)

    def worker():
        start.wait(timeout=30)
        got.extend(make_lock(dev) for _ in range(200))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 3200 and all(lk is got[0] for lk in got)
    assert make_lock(torch.device("cuda", 6)) is not got[0]
    with got[0]:
        with got[0]:
            pass
    cpu = torch.device("cpu")
    assert make_lock(cpu) is not make_lock(cpu)
