"""The port's runtime with the GPU as a pinned resource, on a fake node
of two GPUs (no card needed: a task sees its pin in
CUDA_VISIBLE_DEVICES), torch tensors across processes, and the
runtime's cluster tracing and stack/memory dumps."""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private.serialization import SerializedObject, serialize
from ray_tpu_torch.accelerators import gpu as gpu_mod
from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
          "fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


@pytest.fixture(scope="module")
def ray_start():
    mp = pytest.MonkeyPatch()
    mp.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    mp.setattr(gpu_mod, "_NODE_VISIBLE", None)
    ray_tpu_torch.init(num_cpus=8, num_gpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    mp.undo()


def _tensor(dtype, shape=(33, 17), seed=0):
    """Seeded values of every bit pattern the dtype allows."""
    g = np.random.default_rng(seed)
    if dtype == torch.int8:
        return torch.from_numpy(g.integers(-128, 128, shape, dtype=np.int8))
    x = torch.from_numpy(g.standard_normal(shape).astype(np.float32) * 8)
    return x.to(dtype)


def _bits(t):
    return t.contiguous().view(torch.uint8)


# ------------------------------------------------------------ tensors


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_tensor_serializes_out_of_band_bit_exact(name):
    t = _tensor(DTYPES[name]).t()            # non-contiguous
    s = serialize({"t": t, "k": 1})
    assert len(s.buffers) == 1
    assert len(s.buffers[0]) == t.numel() * t.element_size()
    assert len(s.data) < 400                 # no in-band torch.save bytes
    back = SerializedObject.from_flat(s.to_flat()).deserialize()["t"]
    assert back.dtype == t.dtype and back.shape == t.shape
    assert back.is_contiguous()
    assert torch.equal(_bits(back), _bits(t))


def test_requires_grad_and_parameter_dropped():
    p = torch.nn.Parameter(torch.ones(3))
    back = SerializedObject.from_flat(serialize([p]).to_flat()).deserialize()
    assert type(back[0]) is torch.Tensor and not back[0].requires_grad


@pytest.mark.parametrize("value,want", [
    ({"t": torch.zeros(2)}, True),
    (b"_rebuild_tensor", False),
    ({"a": np.zeros(4), "s": "torch._rebuild_tensor"}, False),
], ids=["tensor", "bytes", "text"])
def test_holds_tensors_set_by_serialize_and_by_deserialize(value, want):
    """The flag that keeps a tensor value out of the caches comes from
    the pickler and the unpickler, not from the text of the stream."""
    s = serialize(value)
    assert s.holds_tensors is want
    received = SerializedObject.from_flat(s.to_flat())
    assert received.holds_tensors is False   # not known before the read
    received.deserialize()
    assert received.holds_tensors is want


@pytest.mark.parametrize("size", [64, 1 << 18], ids=["inline", "arena"])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_tensor_round_trips_and_get_is_a_copy(ray_start, name, size):
    t = _tensor(DTYPES[name], (size // 64, 64), seed=size)
    want = _bits(t).clone()
    ref = ray_tpu_torch.put(t)
    t.view(torch.uint8).fill_(0)             # the put holds a snapshot
    a = ray_tpu_torch.get(ref)
    assert a.dtype == DTYPES[name] and torch.equal(_bits(a), want)
    a.view(torch.uint8).fill_(7)             # a mutated result ...
    b = ray_tpu_torch.get(ref)               # ... leaves the object alone
    assert torch.equal(_bits(b), want)

    @ray_tpu_torch.remote
    def echo(x):
        return x, x.dtype

    out, dtype = ray_tpu_torch.get(echo.remote(ref))
    assert dtype == DTYPES[name] and torch.equal(_bits(out), want)


# -------------------------------------------------------------- GPUs


def test_num_tpus_is_refused():
    with pytest.raises(ValueError, match="num_gpus"):
        ray_tpu_torch.remote(num_tpus=1)(lambda: 0)
    from ray_tpu_torch._private.core import _resources_from_opts
    with pytest.raises(ValueError, match="num_gpus"):
        _resources_from_opts({"num_tpus": 1}, 1.0)
    assert _resources_from_opts({"num_gpus": 1}, 1.0) == {"CPU": 1.0,
                                                          "GPU": 1.0}


def test_gpu_tasks_pinned_on_the_scheduled_path(ray_start):
    """Each num_gpus=1 task sees exactly the device the daemon assigned
    it; a worker never runs under two pins; the pool is whole after."""
    rt = ray_tpu_torch.current_runtime()
    daemon = rt.head_daemon
    assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0

    @ray_tpu_torch.remote(num_gpus=1)
    def which():
        time.sleep(0.05)
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    got = ray_tpu_torch.get([which.remote() for _ in range(12)], timeout=120)
    assert {v for _, v in got} <= {"0", "1"}, got
    pins = {}
    for pid, v in got:
        assert pins.setdefault(pid, v) == v, (pid, pins[pid], v)
    for h in daemon.workers.values():
        assert h.gpu_pin in (None, "0", "1")
    deadline = time.time() + 20
    while time.time() < deadline and len(daemon._free_gpus) < 2:
        time.sleep(0.1)
    assert sorted(daemon._free_gpus) == [0, 1]
    assert ray_tpu_torch.available_resources()["GPU"] == 2.0


def test_gpu_actors_hold_their_device_until_killed(ray_start):
    daemon = ray_tpu_torch.current_runtime().head_daemon

    @ray_tpu_torch.remote(num_gpus=1)
    class Card:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    a, b = Card.remote(), Card.remote()
    seen = ray_tpu_torch.get([a.visible.remote(), b.visible.remote()],
                             timeout=60)
    assert sorted(seen) == ["0", "1"]
    assert daemon._free_gpus == []
    c = Card.remote()                         # no device left: pending
    ready, _ = ray_tpu_torch.wait([c.visible.remote()], timeout=1.0)
    assert not ready
    ray_tpu_torch.kill(a)
    assert ray_tpu_torch.get(c.visible.remote(), timeout=60) == seen[0]
    ray_tpu_torch.kill(b)
    ray_tpu_torch.kill(c)
    deadline = time.time() + 30
    while time.time() < deadline and len(daemon._free_gpus) < 2:
        time.sleep(0.1)
    assert sorted(daemon._free_gpus) == [0, 1]


def test_worker_refuses_a_second_pin_after_cuda_init(monkeypatch):
    from ray_tpu_torch._private.worker_main import WorkerRuntime
    monkeypatch.setattr(gpu_mod, "_NODE_VISIBLE", None)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    w = WorkerRuntime.__new__(WorkerRuntime)
    w._apply_gpu_isolation({"_gpu_ids": [0]})          # same pin: fine
    with pytest.raises(RuntimeError, match="initialized CUDA"):
        w._apply_gpu_isolation({"_gpu_ids": [1]})


# --------------------------------------------------------- detection


def _no_cuda_calls(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the GPU manager called torch.cuda")
    for name in ("device_count", "is_available", "get_device_name",
                 "init", "get_device_properties"):
        monkeypatch.setattr(torch.cuda, name, boom)


@pytest.mark.parametrize("env,devs,want", [
    ({"RAY_TPU_NUM_GPUS": "3", "CUDA_VISIBLE_DEVICES": "0"}, 8, 3),
    ({"CUDA_VISIBLE_DEVICES": "4,6"}, 8, 2),
    ({"CUDA_VISIBLE_DEVICES": ""}, 8, 0),
    ({"NVIDIA_VISIBLE_DEVICES": "2"}, 2, 1),
    ({"NVIDIA_VISIBLE_DEVICES": "all"}, 2, 2),
    ({}, 4, 4),
], ids=["override", "cuda_visible", "cuda_hidden", "container_list",
        "container_all", "dev_nodes"])
def test_detection_from_the_environment(monkeypatch, env, devs, want):
    _no_cuda_calls(monkeypatch)
    for k in ("RAY_TPU_NUM_GPUS", "CUDA_VISIBLE_DEVICES",
              "NVIDIA_VISIBLE_DEVICES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    nodes = [f"/dev/nvidia{i}" for i in range(devs)] + [
        "/dev/nvidiactl", "/dev/nvidia-uvm"]
    monkeypatch.setattr(gpu_mod.glob, "glob", lambda pat: nodes)
    monkeypatch.setattr(GPUAcceleratorManager,
                        "get_current_node_accelerator_type",
                        staticmethod(lambda: "NVIDIA-H100-80GB-HBM3"))
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == want
    res = GPUAcceleratorManager.autodetect_resources()
    assert res == ({"GPU": float(want),
                    "GPU-NVIDIA-H100-80GB-HBM3": float(want)}
                   if want else {})


def test_pins_map_through_the_nodes_own_list(monkeypatch):
    monkeypatch.setattr(gpu_mod, "_NODE_VISIBLE", "3,5")
    assert GPUAcceleratorManager.visible_value([1]) == "5"
    monkeypatch.setattr(gpu_mod, "_NODE_VISIBLE", None)
    assert GPUAcceleratorManager.visible_value([1]) == "1"


# ----------------------------------------------- tracing and profiling


def test_worker_spans_reach_collect_cluster(ray_start):
    from ray_tpu_torch.util import tracing
    tracing.enable()
    try:
        @ray_tpu_torch.remote
        def traced():
            return tracing.current_context()

        with tracing.span("driver_work") as driver_ctx:
            ref = traced.remote()
        worker_ctx = ray_tpu_torch.get(ref, timeout=60)
        assert worker_ctx["trace_id"] == driver_ctx["trace_id"]
        starts = [e for e in tracing.get_events() if e.get("ph") == "s"]
        assert starts
        deadline = time.time() + 15
        finishes = []
        while time.time() < deadline and not finishes:
            finishes = [e for e in tracing.collect_cluster()
                        if e.get("ph") == "f"]
            time.sleep(0.2)
        assert finishes, "worker flow-finish never flushed"
        assert {e["id"] for e in finishes} <= {e["id"] for e in starts}
        assert any(e.get("cat") == "task::execute"
                   and e.get("pid") != os.getpid()
                   for e in tracing.collect_cluster())
    finally:
        tracing.disable()
        tracing.clear()


def test_stacks_and_memory_through_daemon_and_worker(ray_start):
    @ray_tpu_torch.remote
    class Holder:
        def pid(self):
            return os.getpid()

    h = Holder.remote()
    pid = ray_tpu_torch.get(h.pid.remote(), timeout=60)
    rt = ray_tpu_torch.current_runtime()
    client = rt.client
    stacks = client.daemon_rpc(rt.head_daemon.address, "node_stacks")
    assert "=== daemon" in stacks and f"=== worker pid {pid}" in stacks
    assert "--- thread" in stacks.split(f"=== worker pid {pid}")[1]
    worker = next(w for w in rt.head_daemon.workers.values()
                  if w.pid == pid)
    mem = client.daemon_rpc(worker.addr, "memory_summary")
    assert mem["rss_bytes"] > 0
    assert "cuda_allocated_bytes" not in mem   # CUDA never initialized
    assert "--- thread" in client.daemon_rpc(worker.addr, "dump_stacks")
    ray_tpu_torch.kill(h)
