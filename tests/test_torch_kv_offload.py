"""ray_tpu_torch's KV memory hierarchy against ray_tpu's.

- `pick_victim` and `HostKVTier` give the reference's victims and
  accounting on the same seeded slot sets and operation sequences;
- a manual preempt (spill) and restore, greedy and sampled, on f32,
  int8 and fp8 pages, both impls and both readback modes, is token-exact
  against a never-preempted port engine; so is a prefilling request's
  requeue;
- the reference's half-pages oversubscription workload
  (tests/test_kv_offload.py): every request ends with "length" and the
  port gives the JAX engine's tokens and its preemption counts by
  reason, spills and restores, with the JAX gather engine built as in
  tests/test_torch_engine_pipeline.py (async_readback=False) for the
  synchronous port, and the reference's pipelined engine for the counts
  of the pipelined port (no stop tokens: its control flow does not
  depend on token values);
- the edges: a full host tier ends the victim with "error", the
  watermark requires offload, growth clamps at max_seq, abort and
  deadline while parked, priority steers the victim, parked requests
  restore before new admissions, a MemoryError out of the allocator is
  caught at step(), and after the storm a steady window is clean under
  the port's dispatch_guard.

float32 debug model, CPU.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as je
from ray_tpu.llm._internal import kv_offload as jko
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.llm._internal import kv_offload as tko
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.util.dispatch_guard import dispatch_guard

torch.set_num_threads(1)

ENGINE_KW = dict(max_batch_size=4, page_size=8, num_pages=64,
                 max_prefill_tokens=16, seed=9)
# the reference's oversubscription gate: worst case (12 + 44 tokens) is
# 7 pages a request, a resident batch of 4 wants 28, the pool has 14
OVERSUB = dict(num_pages=15, enable_kv_offload=True, kv_watermark_tokens=8)
WORKLOADS = {
    "greedy": dict(max_tokens=44),
    "sampled": dict(max_tokens=44, temperature=0.7, top_p=0.9),
}


def _jax_engine(**over):
    kw = dict(ENGINE_KW, model=jl.config("debug", dtype=jnp.float32),
              prefill_buckets=(16, 32, 64), decode_impl="gather",
              async_readback=False)
    kw.update(over)
    return je.InferenceEngine(je.EngineConfig(**kw))


_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS.update(jax.tree_util.tree_map(np.asarray,
                                              _jax_engine().params))
    return _PARAMS


def _engine(impl="gather", **over):
    kw = dict(ENGINE_KW, model=tl.config("debug", dtype=torch.float32),
              device="cpu", decode_impl=impl)
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw), params=_params())


def _requests(mod, n, sp, seed=7, prompt_len=12):
    rng = np.random.default_rng(seed)
    return [mod.Request(f"q{i}", rng.integers(2, 250, prompt_len).tolist(),
                        mod.SamplingParams(**sp)) for i in range(n)]


def _run(eng, cap=5000):
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < cap, "engine failed to converge"
    return steps


def _counts(eng):
    tier = eng.host_tier
    return (dict(eng.preempt_counts), tier.spills_total,
            tier.restores_total)


# ------------------------------------------- policy and accounting

class _Req:
    def __init__(self, rid, priority, submitted_at):
        self.request_id = rid
        self.priority = priority
        self.submitted_at = submitted_at


class _Slot:
    def __init__(self, index, request, ready):
        self.index = index
        self.request = request
        self.ready = ready


@pytest.mark.parametrize("seed", range(4))
def test_pick_victim_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 9))
        slots = [_Slot(i, (None if rng.random() < 0.2 else _Req(
            f"r{int(rng.integers(6))}", int(rng.integers(-1, 2)),
            float(rng.integers(4)))), bool(rng.random() < 0.6))
            for i in range(n)]
        protect = [i for i in range(n) if rng.random() < 0.3]
        for spill_ok in (True, False):
            want = jko.pick_victim(slots, protect, spill_ok=spill_ok)
            got = tko.pick_victim(slots, protect, spill_ok=spill_ok)
            assert got is want
        for s in slots:
            if s.request is not None:
                assert tko.victim_order_key(s) == jko.victim_order_key(s)


@pytest.mark.parametrize("capacity", [None, 12])
def test_host_tier_accounting_matches_reference(capacity):
    """The same park / pop / export / drop sequence on both tiers: the
    same stats after every operation, the same refusals."""
    rng = np.random.default_rng(11)
    tiers = [jko.HostKVTier(capacity), tko.HostKVTier(capacity)]
    seqs = [jko.ParkedSequence, tko.ParkedSequence]
    live = []
    for step in range(200):
        op = int(rng.integers(4))
        if op == 0 or not live:
            n = int(rng.integers(1, 5))
            rid = f"s{step}"
            kv = rng.standard_normal((2, n, 4, 2, 8)).astype(np.float32)
            spill = bool(rng.random() < 0.8)       # else an import
            outcome = []
            for tier, cls in zip(tiers, seqs):
                parked = cls(request=_Req(rid, 0, 0.0), seed=1, position=n,
                             last_token=3, n_pages=n, reason="growth",
                             k_host=kv, v_host=kv)
                try:
                    tier.park(parked, count_spill=spill)
                    outcome.append("ok")
                except MemoryError:
                    outcome.append("full")
            assert outcome[0] == outcome[1]
            if outcome[0] == "ok":
                live.append(rid)
        else:
            rid = live.pop(int(rng.integers(len(live))))
            name = ("pop", "export", "drop")[op - 1]
            got = [getattr(t, name)(rid).request.request_id for t in tiers]
            assert got == [rid, rid]
        assert tiers[0].stats() == tiers[1].stats()
        assert [p.request.request_id for p in tiers[0].entries()] \
            == [p.request.request_id for p in tiers[1].entries()]
    assert tiers[1].drop("absent") is None


# ---------------------------------------------- preempt and restore

KINDS = ["f32", "int8", "fp8"]
PREEMPT_SP = {
    "greedy": dict(max_tokens=24),
    "sampled": dict(max_tokens=24, temperature=0.8, top_p=0.9, top_k=20,
                    repetition_penalty=1.1),
}


def _preempt_run(eng, sp, victim="q1", after=5):
    reqs = _requests(te, 3, sp)
    for r in reqs:
        eng.add_request(r)
    if victim is not None:
        while len(reqs[1].output_tokens) < after:
            eng.step()
        assert eng.preempt(victim)
        assert eng.stats()["parked_sessions"] == 1
        assert eng.stats()["page_pressure"] > 0
    _run(eng)
    return [r.output_tokens for r in reqs], reqs


@pytest.mark.parametrize("async_rb", [True, False],
                         ids=["pipelined", "sync"])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_preempt_restore_token_exact(mode, kind, impl, async_rb):
    sp = PREEMPT_SP[mode]
    kw = dict(kv_dtype=kind, async_readback=async_rb)
    want, _ = _preempt_run(_engine(impl, **kw), sp, victim=None)
    eng = _engine(impl, enable_kv_offload=True, **kw)
    got, reqs = _preempt_run(eng, sp)
    assert got == want
    st = eng.stats()
    assert st["preemptions"] == {"manual": 1}
    assert st["kv"]["spills_total"] == st["kv"]["restores_total"] == 1
    assert st["parked_sessions"] == 0 and st["kv_host_bytes_used"] == 0
    assert reqs[1].restarts == 1
    assert all(r.finish_reason == "length" for r in reqs)


def test_prefilling_victim_requeues_token_exact():
    """A prefilling request requeues at the head of the queue (no host
    tier needed) and its stream is the never-preempted one."""
    sp = dict(max_tokens=10)
    long_p = list(range(3, 43))            # three 16-token chunks
    want = _engine().generate([long_p], te.SamplingParams(**sp))
    eng = _engine(enable_kv_offload=True)
    req = te.Request("long", long_p, te.SamplingParams(**sp))
    eng.add_request(req)
    eng.step()
    assert not eng.slots[0].ready
    assert eng.preempt("long")
    assert eng.waiting[0] is req and req.restarts == 1
    _run(eng)
    assert req.output_tokens == want[0].output_tokens
    assert eng.preempt_counts == {"manual": 1}
    assert eng.host_tier.spills_total == 0


def test_preempt_without_tier_or_room_refuses():
    eng = _engine()
    reqs = _requests(te, 2, dict(max_tokens=24))
    for r in reqs:
        eng.add_request(r)
    while len(reqs[0].output_tokens) < 10:
        eng.step()
    assert not eng.preempt("q0")              # no host tier
    small = _engine(enable_kv_offload=True, host_kv_pages=1)
    reqs = _requests(te, 2, dict(max_tokens=24))
    for r in reqs:
        small.add_request(r)
    while len(reqs[0].output_tokens) < 10:
        small.step()
    assert not small.preempt("q0")            # needs more than 1 page
    assert not small.preempt("absent")
    _run(small)
    assert all(r.finish_reason == "length" for r in reqs)


# --------------------------------------------- oversubscription

@pytest.fixture(scope="module")
def jax_oversub():
    """The JAX gather engine on the half-pages workload, synchronous
    (tokens and counts) for both workloads, and pipelined for the
    greedy workload's counts."""
    out = {}
    for mode, sp in WORKLOADS.items():
        eng = _jax_engine(**OVERSUB)
        reqs = _requests(je, 8, sp)
        for r in reqs:
            eng.add_request(r)
        _run(eng)
        out[mode, "sync"] = ([r.output_tokens for r in reqs], _counts(eng))
    eng = _jax_engine(async_readback=True, **OVERSUB)
    for r in _requests(je, 8, WORKLOADS["greedy"]):
        eng.add_request(r)
    _run(eng)
    out["pipelined"] = _counts(eng)
    return out


@pytest.mark.parametrize("async_rb", [True, False],
                         ids=["pipelined", "sync"])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_oversubscription_matches_jax(jax_oversub, mode, impl, async_rb):
    eng = _engine(impl, async_readback=async_rb, **OVERSUB)
    reqs = _requests(te, 8, WORKLOADS[mode])
    for r in reqs:
        eng.add_request(r)           # no capacity reject
    _run(eng)
    tokens, counts = jax_oversub[mode, "sync"]
    assert [r.output_tokens for r in reqs] == tokens
    assert all(r.finish_reason == "length" for r in reqs)
    assert _counts(eng) == (jax_oversub["pipelined"] if async_rb
                            else counts)
    spills, restores = _counts(eng)[1:]
    assert spills >= 1 and restores >= 1
    assert len(eng.parked) == 0 and eng.host_tier.used_pages == 0
    eng.allocator.clear_cache()
    assert eng.allocator.used_pages == 0
    assert eng.stats()["page_pressure"] == 0.0


def test_steady_window_clean_after_the_storm():
    """After a spill/restore storm settles into a resident batch with
    fully grown reservations, 32 ticks make no upload and no capture,
    and read back once a tick: the hierarchy lives on the structural
    path."""
    eng = _engine(num_pages=42, enable_kv_offload=True,
                  kv_watermark_tokens=8)
    for r in _requests(te, 6, dict(max_tokens=84)):
        eng.add_request(r)
    _run(eng)
    assert eng.host_tier.spills_total >= 1
    steady = _requests(te, 4, dict(max_tokens=64), seed=11)
    for r in steady:
        eng.add_request(r)
    page = eng.allocator.page_size

    def fully_grown():
        slots = [s for s in eng.slots if s.request is not None]
        return (not eng.waiting and len(slots) == 4
                and all(s.ready and len(s.pages) * page
                        >= s.position + (s.request.params.max_tokens
                                         - len(s.request.output_tokens))
                        + 1 for s in slots))

    steps = 0
    while not fully_grown():
        eng.step()
        steps += 1
        assert steps < 500, "steady batch never fully grew"
    for _ in range(4):
        eng.step()
    ticks = eng.decode_ticks
    with dispatch_guard(engine=eng) as report:
        for _ in range(32):
            eng.step()
    assert report.uploads == [] and report.captures == []
    assert report.readbacks == 32 and eng.decode_ticks == ticks + 32
    assert all(s.request is not None and s.ready for s in eng.slots)


# ------------------------------------------------------------ edges

def test_full_host_tier_ends_the_victim_with_error():
    eng = _engine(num_pages=11, enable_kv_offload=True, host_kv_pages=1,
                  kv_watermark_tokens=8)
    reqs = _requests(te, 2, dict(max_tokens=44))
    for r in reqs:
        eng.add_request(r)
    _run(eng)
    assert sorted(r.finish_reason for r in reqs) == ["error", "length"]
    fresh = te.Request("fresh", list(range(2, 14)),
                       te.SamplingParams(max_tokens=8))
    eng.add_request(fresh)
    _run(eng)
    assert fresh.finish_reason == "length"


def test_watermark_validation():
    with pytest.raises(ValueError, match="enable_kv_offload"):
        _engine(kv_watermark_tokens=8)
    with pytest.raises(ValueError, match=">= 1"):
        _engine(kv_watermark_tokens=0, enable_kv_offload=True)


@pytest.mark.parametrize("async_rb", [True, False],
                         ids=["pipelined", "sync"])
def test_growth_clamped_to_final_need_at_max_seq(async_rb):
    """A request sized exactly to max_seq_len grows to the last page of
    its table row and no further."""
    eng = _engine(max_seq_len=16, num_pages=32, max_batch_size=2,
                  max_prefill_tokens=8, enable_kv_offload=True,
                  kv_watermark_tokens=4, async_readback=async_rb)
    req = te.Request("edge", list(range(2, 10)),
                     te.SamplingParams(max_tokens=8))
    eng.add_request(req)
    _run(eng)
    assert req.finish_reason == "length" and len(req.output_tokens) == 8


def test_abort_while_parked_drops_host_kv():
    eng = _engine(max_batch_size=3, enable_kv_offload=True)
    reqs = _requests(te, 3, dict(max_tokens=32))
    for r in reqs:
        eng.add_request(r)
    while len(reqs[2].output_tokens) < 4:
        eng.step()
    assert eng.preempt("q2")
    assert eng.abort("q2")
    assert reqs[2].finish_reason == "abort"
    assert len(eng.parked) == 0 and eng.host_tier.used_pages == 0
    assert eng.host_tier.used_bytes == 0
    _run(eng)
    assert all(r.finish_reason == "length" for r in reqs[:2])


def test_deadlines_parked_running_and_waiting():
    eng = _engine(max_batch_size=2, enable_kv_offload=True)
    reqs = _requests(te, 4, dict(max_tokens=32))
    for r in reqs:
        eng.add_request(r)
    while len(reqs[1].output_tokens) < 4:
        eng.step()
    assert eng.preempt("q1")
    past = time.monotonic() - 0.001
    reqs[1].deadline = past                # parked
    reqs[0].deadline = past                # running
    reqs[3].deadline = past                # waiting
    touched = eng.step()
    for i in (0, 1, 3):
        assert reqs[i].finish_reason == "deadline" and reqs[i] in touched
    assert len(eng.parked) == 0 and eng.host_tier.dropped_total == 1
    _run(eng)
    assert reqs[2].finish_reason == "length"
    assert eng.stats()["kv"]["used_pages"] <= eng.allocator.cached_pages


def test_priority_steers_the_victim():
    eng = _engine(num_pages=13, max_batch_size=2, enable_kv_offload=True,
                  kv_watermark_tokens=8)
    sp = te.SamplingParams(max_tokens=44)
    hi = te.Request("hi", list(range(2, 14)), sp, priority=5)
    lo = te.Request("lo", list(range(30, 42)), sp, priority=0)
    eng.add_request(hi)
    eng.add_request(lo)
    parked = set()
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        parked |= {p.request.request_id for p in eng.parked}
        assert steps < 3000
    assert hi.finish_reason == "length" and lo.finish_reason == "length"
    assert "lo" in parked and "hi" not in parked


def test_parked_restores_before_new_admissions():
    eng = _engine(max_batch_size=2, enable_kv_offload=True)
    first = _requests(te, 2, dict(max_tokens=24))
    for r in first:
        eng.add_request(r)
    while len(first[1].output_tokens) < 4:
        eng.step()
    assert eng.preempt("q1")
    late = te.Request("late", list(range(2, 14)),
                      te.SamplingParams(max_tokens=8))
    eng.add_request(late)
    eng.step()                       # the restore takes the free slot
    assert any(s.request is first[1] for s in eng.slots)
    assert late in eng.waiting
    _run(eng)
    assert late.finish_reason == "length"
    assert first[1].finish_reason == "length"


def test_memory_error_at_the_step_boundary():
    """A MemoryError from an allocation no check covered finishes the
    allocating request with "error"; the engine keeps serving."""
    eng = _engine()
    orig = eng.allocator.allocate_pages
    armed = [True]

    def boom(n):
        if armed[0]:
            armed[0] = False
            raise MemoryError("synthetic exhaustion")
        return orig(n)

    eng.allocator.allocate_pages = boom
    req = te.Request("z0", list(range(2, 14)), te.SamplingParams(max_tokens=8))
    eng.add_request(req)
    touched = eng.step()
    assert req.finish_reason == "error" and req in touched
    r2 = te.Request("z1", list(range(2, 14)), te.SamplingParams(max_tokens=6))
    eng.add_request(r2)
    _run(eng)
    assert r2.finish_reason == "length"


def test_lora_requests_are_refused():
    eng = _engine()
    with pytest.raises(ValueError, match="LoRA"):
        eng.add_request(te.Request("l", [3, 4], te.SamplingParams(),
                                   lora="adapter"))
