"""ray_tpu_torch's cost model and perf accountant against ray_tpu's.

- CostModel: decode_cost, chunk_cost, forward_flops, weight_bytes and
  page_bytes (and the per-token constants) equal the JAX package's
  exactly, for the debug preset and for 8b at full width, on f32, int8
  and fp8 pages (closed forms: cheap at any width);
- PerfAccountant: summary() and brief() equal on the same synthetic
  tick stream under the same clock;
- the envelope table: the JAX package's rows unchanged, plus "h100"
  (989e12 FLOP/s, 3.35e12 B/s); detect_envelope maps the CPU to "cpu",
  an H100 to "h100", and raises on an unknown card or name;
- the engine's cost model: the JAX closed form at the dtype the engine
  stores its weights in (the compute dtype; the JAX engine stores them
  in param_dtype), so receipts agree bit for bit where the two store
  the same dtype and differ in the weight term where they do not.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from ray_tpu.llm._internal import perfmodel as jpm
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.llm._internal import perfmodel as tpm
from ray_tpu_torch.models import llama as tl

KINDS = ["f32", "int8", "fp8"]


def _configs(preset):
    if preset == "debug":
        return (jl.config("debug", dtype=jnp.float32),
                tl.config("debug", dtype=torch.float32))
    return jl.config(preset), tl.config(preset)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("preset", ["debug", "8b"])
def test_cost_model_equals_jax(preset, kind):
    jc, tc = _configs(preset)
    for page in (8, 16):
        jm = jpm.CostModel(jc, page, kv_dtype=kind)
        tm = tpm.CostModel(tc, page, kv_dtype=kind)
        for attr in ("gemm_flops_per_token", "head_flops",
                     "attn_flops_per_pair", "weight_bytes",
                     "kv_bytes_per_token", "page_bytes"):
            assert getattr(tm, attr) == getattr(jm, attr), attr
        for ctx in (0, 1, 7, 8, 9, 100, 1535, 4096):
            assert tm.decode_cost(ctx) == jm.decode_cost(ctx)
        for start, n in ((0, 1), (0, 16), (5, 3), (17, 64), (1024, 512),
                         (4000, 96)):
            assert tm.chunk_cost(start, n) == jm.chunk_cost(start, n)
        for b, s in ((1, 1), (2, 33), (4, 2048)):
            assert tm.forward_flops(b, s) == jm.forward_flops(b, s)


def test_cost_model_8b_bytes():
    """The 8b numbers PERF.md quotes: weights at the storage dtype of
    each package's engine, a bf16 page of 16 rows 2 MiB."""
    jc, tc = _configs("8b")
    assert tpm.CostModel(tc, 16).weight_bytes == 4 * tc.num_params()
    bf16 = tpm.CostModel(dataclasses.replace(tc, param_dtype=tc.dtype), 16)
    assert bf16.weight_bytes == 2 * tc.num_params() == 16_060_522_496
    assert bf16.page_bytes == 2 * 2 ** 20


def _stream(acc, clock, model):
    """A synthetic tick stream: ragged, decode, an offload, an empty
    tick, an aborted one."""
    c = model.chunk_cost(0, 12)
    acc.add("ragged", dict(c), prefill_tokens=12)
    clock[0] = 10.0
    acc.commit(3.5)
    for i in range(5):
        d = model.decode_cost(13 + i)
        acc.add("decode", dict(d), decode_tokens=2)
        if i == 2:
            acc.note_offload(d2h=4 * model.page_bytes)
        clock[0] = 10.01 + 0.004 * i
        acc.commit(4.0 + 0.25 * i)
    acc.commit(1.0)                    # nothing pending: no sample
    acc.add("decode", model.decode_cost(30), decode_tokens=1)
    acc.abort_tick()
    acc.note_offload(h2d=2 * model.page_bytes)
    clock[0] = 10.2
    acc.commit(0.7)


@pytest.mark.parametrize("envelope", ["cpu", "tpu-v5e"])
def test_accountant_summary_and_brief_equal_jax(monkeypatch, envelope):
    clock = [0.0]
    monkeypatch.setattr(jpm.time, "monotonic", lambda: clock[0])
    assert tpm.time is jpm.time
    jc, tc = _configs("debug")
    ja = jpm.PerfAccountant(jpm.CostModel(jc, 8), jpm.ENVELOPES[envelope])
    ta = tpm.PerfAccountant(tpm.CostModel(tc, 8), tpm.ENVELOPES[envelope])
    _stream(ja, clock, ja.model)
    _stream(ta, clock, ta.model)
    assert ta.summary() == ja.summary()
    assert ta.brief() == ja.brief()
    assert ta.totals() == ja.totals()
    assert ta.summary()["window"] == 7


def test_envelope_table():
    for name, env in jpm.ENVELOPES.items():
        mine = tpm.ENVELOPES[name]
        assert (mine.peak_flops, mine.peak_bytes_per_s) == \
            (env.peak_flops, env.peak_bytes_per_s)
    h100 = tpm.ENVELOPES["h100"]
    assert h100.peak_flops == 989e12 and h100.peak_bytes_per_s == 3.35e12
    assert h100.source == "NVIDIA H100 SXM5 datasheet"
    assert set(tpm.ENVELOPES) == set(jpm.ENVELOPES) | {"h100"}


def test_detect_envelope(monkeypatch):
    assert tpm.detect_envelope(torch.device("cpu")).name == "cpu"
    assert tpm.detect_envelope("cpu", name="tpu-v5e").name == "tpu-v5e"
    assert tpm.envelope_for_card("NVIDIA H100 80GB HBM3").name == "h100"
    assert tpm.envelope_for_card("NVIDIA H100 PCIe").name == "h100"
    with pytest.raises(ValueError, match="unknown perf envelope"):
        tpm.detect_envelope(name="h200")
    with pytest.raises(ValueError, match="perf_envelope"):
        tpm.envelope_for_card("NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tpm.detect_envelope(torch.device("cuda", 0)).name == "h100"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Tesla V100-SXM2-16GB")
    with pytest.raises(ValueError, match="perf_envelope"):
        tpm.detect_envelope("cuda")


def test_engine_envelope_resolution():
    cfg = tl.config("debug", dtype=torch.float32)
    eng = te.InferenceEngine(te.EngineConfig(model=cfg, device="cpu",
                                             num_pages=16))
    assert eng.perf.envelope.name == "cpu"
    eng = te.InferenceEngine(te.EngineConfig(
        model=cfg, device="cpu", num_pages=16, perf_envelope="h100"))
    assert eng.perf.envelope.name == "h100"
    with pytest.raises(ValueError, match="unknown perf envelope"):
        te.InferenceEngine(te.EngineConfig(model=cfg, device="cpu",
                                           num_pages=16,
                                           perf_envelope="h200"))
    off = te.InferenceEngine(te.EngineConfig(
        model=cfg, device="cpu", num_pages=16,
        enable_perf_accounting=False))
    assert off.perf is None and off.attrib is None and off.anomaly is None
    assert off.stats()["perf"] == {"enabled": False}


@pytest.mark.parametrize("kind", KINDS)
def test_engine_cost_model_at_storage_dtype(kind):
    """A float32 model stores float32 in both packages: the engine's
    cost model is the JAX engine's. A bf16-compute model with float32
    param_dtype: the JAX engine stores (and counts) float32 weights,
    this engine stores bf16 and counts bf16; only the weight term
    differs."""
    f32 = tl.config("debug", dtype=torch.float32)
    eng = te.InferenceEngine(te.EngineConfig(model=f32, device="cpu",
                                             num_pages=16, kv_dtype=kind))
    jm = jpm.CostModel(jl.config("debug", dtype=jnp.float32), 16,
                       kv_dtype=kind)
    for attr in ("weight_bytes", "page_bytes", "gemm_flops_per_token",
                 "kv_bytes_per_token"):
        assert getattr(eng.perf.model, attr) == getattr(jm, attr)
    bf = tl.config("debug")            # bf16 compute, float32 storage
    eng = te.InferenceEngine(te.EngineConfig(model=bf, device="cpu",
                                             num_pages=16, kv_dtype=kind))
    jm = jpm.CostModel(jl.config("debug"), 16, kv_dtype=kind)
    assert eng.perf.model.weight_bytes * 2 == jm.weight_bytes
    assert eng.perf.model.weight_bytes == 2 * bf.num_params()
    assert eng.perf.model.page_bytes == jm.page_bytes
    assert eng.perf.model.decode_cost(40) == jm.decode_cost(40)
