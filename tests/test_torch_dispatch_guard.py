"""ray_tpu_torch.util.dispatch_guard: the port of ray_tpu/util/jax_guard.

- 32 consecutive steady decode ticks make no engine upload (the loop
  state is device-resident and feeds back on the device), no new graph
  capture, and one readback a tick, through _read_tokens: greedy and
  sampled with penalties, pipelined and synchronous readback, both
  impls (on the CPU no graph is captured; the card's case, with the
  graph capture budgeted in the warm-up, is in test_torch_cuda_kernels);
- an admission inside the section is an upload, and raises;
- the guard itself: a seeded upload raises at its site, captures over
  the budget raise when the block exits (and land in the flight
  recorder as a guard_violation, black-boxed), a budget admits warm-up,
  and report-only mode collects without raising.

Every engine here runs with every observability switch on (the
defaults: telemetry, the cost model, attribution, the anomaly detector,
the black box): the steady window holds with all of it recording.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.util.dispatch_guard import (GuardViolation,
                                               dispatch_guard)

torch.set_num_threads(1)


def _engine(**over):
    kw = dict(model=tl.config("debug", dtype=torch.float32), device="cpu",
              max_batch_size=3, page_size=8, num_pages=64,
              max_prefill_tokens=16, seed=9)
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw))


def _warmed_engine(async_readback=True, impl="gather", **sp_over):
    """Three requests past prefill, decode loop settled."""
    eng = _engine(async_readback=async_readback, decode_impl=impl)
    rng = np.random.default_rng(5)
    sp = dict(max_tokens=64)
    sp.update(sp_over)
    for i in range(3):
        eng.add_request(te.Request(f"g{i}", rng.integers(2, 250, 12).tolist(),
                                   te.SamplingParams(**sp)))
    while eng.waiting or any(s.request is not None and not s.ready
                             for s in eng.slots):
        eng.step()
    for _ in range(4):
        eng.step()
    return eng


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("async_rb", [True, False],
                         ids=["pipelined", "sync"])
@pytest.mark.parametrize("sp", [
    {},
    {"temperature": 0.8, "top_k": 20, "top_p": 0.9,
     "repetition_penalty": 1.2},
], ids=["greedy", "sampled_penalized"])
def test_steady_decode_no_uploads_no_captures_one_readback(sp, async_rb,
                                                           impl):
    eng = _warmed_engine(async_rb, impl, **sp)
    assert eng.telemetry.enabled and eng.perf is not None \
        and eng.attrib is not None and eng.anomaly is not None \
        and eng.config.enable_blackbox
    ticks = eng.decode_ticks
    samples = eng.perf.totals()["samples"]
    tokens = eng.telemetry.summary()["generated_tokens"]
    with dispatch_guard(engine=eng) as report:
        for _ in range(32):
            eng.step()
    assert report.uploads == [] and report.captures == []
    assert report.readbacks == 32
    assert eng.decode_ticks == ticks + 32
    assert all(s.request is not None for s in eng.slots)
    # the observability recorded every guarded tick
    assert eng.perf.totals()["samples"] == samples + 32
    assert eng.telemetry.summary()["generated_tokens"] == tokens + 3 * 32
    assert eng.anomaly.stats()["ticks"] >= 32


def test_guard_raises_on_seeded_upload():
    eng = _warmed_engine()
    with pytest.raises(GuardViolation, match="host-to-device"):
        with dispatch_guard(engine=eng):
            eng.step()
            eng._dev(np.arange(3, dtype=np.int32))
    assert eng._guard is None                   # disarmed on the way out


def test_guard_raises_on_a_structural_upload_in_the_section():
    """An admission refills the static state and uploads the ragged
    tick's metadata: not a steady section."""
    eng = _warmed_engine(max_tokens=8)
    eng.add_request(te.Request("late", [5, 6, 7], te.SamplingParams()))
    with pytest.raises(GuardViolation, match="host-to-device"):
        with dispatch_guard(engine=eng):
            for _ in range(8):
                eng.step()


def test_guard_capture_budget_admits_warmup(tmp_path):
    eng = _engine(blackbox_dir=str(tmp_path))
    with dispatch_guard(max_captures=1, engine=eng) as report:
        with eng._capturing():
            pass
    assert len(report.captures) == 1
    with pytest.raises(GuardViolation, match="capture"):
        with dispatch_guard(engine=eng):
            with eng._capturing():
                pass
    assert eng.graph_captures == 2
    ev = [e for e in eng.telemetry.recorder.events()
          if e["event"] == "guard_violation"]
    assert len(ev) == 1 and ev[0]["cause"] == "capture" \
        and ev[0]["n_captures"] == 1 and ev[0]["budget"] == 0
    assert [b["cause"] for b in eng.blackbox.list()] == ["guard_violation"]


def test_guard_report_only_mode_collects_without_raising():
    eng = _warmed_engine(max_tokens=8)
    eng.add_request(te.Request("late", [5, 6, 7],
                               te.SamplingParams(max_tokens=4)))
    with dispatch_guard(engine=eng, raise_on_violation=False) as report:
        with eng._capturing():
            pass
        while eng.has_work():
            eng.step()
    assert "slot state" in report.uploads
    assert len(report.captures) == 1
    assert report.readbacks > 0


def test_guard_refuses_to_nest():
    eng = _engine()
    with dispatch_guard(engine=eng):
        with pytest.raises(RuntimeError, match="already armed"):
            with dispatch_guard(engine=eng):
                pass
