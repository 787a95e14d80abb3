"""Streaming generators (num_returns="streaming").

Reference parity: python/ray/_raylet.pyx:295 ObjectRefGenerator +
task_manager.h:364 — generator tasks' yields are consumed incrementally
across processes, with backpressure, for both tasks and actor methods.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_task_streaming_basic(ray_start):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    out = [ray_tpu_torch.get(ref) for ref in gen.remote(5)]
    assert out == [0, 1, 4, 9, 16]


def test_task_streaming_incremental(ray_start):
    """Items are consumable before the generator finishes."""
    @ray_tpu_torch.remote(num_returns="streaming")
    def slow_gen():
        for i in range(3):
            time.sleep(0.3)
            yield i

    t0 = time.time()
    it = slow_gen.remote()
    first = ray_tpu_torch.get(next(it))
    first_latency = time.time() - t0
    rest = [ray_tpu_torch.get(r) for r in it]
    total = time.time() - t0
    assert first == 0 and rest == [1, 2]
    # first item arrived well before the whole stream finished
    assert first_latency < total - 0.25, (first_latency, total)


def test_task_streaming_large_items(ray_start):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen():
        for i in range(3):
            yield np.full((512, 512), i, np.float32)   # 1 MB, shm path

    for i, ref in enumerate(gen.remote()):
        arr = ray_tpu_torch.get(ref)
        assert arr.shape == (512, 512) and float(arr[0, 0]) == i


def test_task_streaming_error_mid_stream(ray_start):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen():
        yield 1
        raise ValueError("boom")

    it = gen.remote()
    assert ray_tpu_torch.get(next(it)) == 1
    err_ref = next(it)
    with pytest.raises(Exception, match="boom"):
        ray_tpu_torch.get(err_ref)
    with pytest.raises(StopIteration):
        next(it)


def test_task_streaming_backpressure(ray_start):
    """With backpressure N, the producer pauses until items are consumed."""
    @ray_tpu_torch.remote(num_returns="streaming",
                    _generator_backpressure_num_objects=2)
    def gen():
        import time as _t
        for i in range(6):
            yield (i, _t.time())

    it = gen.remote()
    time.sleep(1.0)                  # give the producer time to run ahead
    stamps = []
    for ref in it:
        i, ts = ray_tpu_torch.get(ref)
        stamps.append(ts)
        time.sleep(0.1)
    # later items must have been produced AFTER we started consuming:
    # without backpressure all six stamps land within the first ~50ms.
    assert stamps[-1] - stamps[0] > 0.2, stamps


def test_actor_streaming(ray_start):
    @ray_tpu_torch.remote
    class Streamer:
        def tokens(self, n):
            for i in range(n):
                yield f"tok{i}"

    a = Streamer.remote()
    out = [ray_tpu_torch.get(r)
           for r in a.tokens.options(num_returns="streaming").remote(4)]
    assert out == ["tok0", "tok1", "tok2", "tok3"]


def test_streaming_non_iterable_is_task_error(ray_start):
    @ray_tpu_torch.remote(num_returns="streaming")
    def not_a_gen():
        return 42

    it = not_a_gen.remote()
    ref = next(it)
    with pytest.raises(Exception, match="generator"):
        ray_tpu_torch.get(ref)
    with pytest.raises(StopIteration):
        next(it)


def test_streaming_abandon_cancels_producer(ray_start):
    """Breaking out of iteration cancels the producer instead of leaking
    an unbounded stream."""
    @ray_tpu_torch.remote(num_returns="streaming",
                    _generator_backpressure_num_objects=2)
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = endless.remote()
    first = ray_tpu_torch.get(next(it))
    assert first == 0
    it.close()
    # The producer's worker must become reusable again (stream cancelled,
    # run_task RPC completed) — a plain task on the same pool proves it.
    @ray_tpu_torch.remote
    def ping():
        return "ok"
    assert ray_tpu_torch.get(ping.remote(), timeout=120) == "ok"


def test_streaming_sync_actor_serial_guarantee(ray_start):
    """A streaming method's body runs on the actor's executor: a normal
    call issued mid-stream must not interleave with it."""
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.in_gen = False

        def gen(self, n):
            self.in_gen = True
            for i in range(n):
                import time as _t
                _t.sleep(0.05)
                yield i
            self.in_gen = False

        def probe(self):
            return self.in_gen

    a = Counter.remote()
    it = a.gen.options(num_returns="streaming").remote(5)
    # probe is admitted after the stream finishes (serial executor),
    # so it must observe in_gen == False
    assert ray_tpu_torch.get(a.probe.remote()) is False
    assert [ray_tpu_torch.get(r) for r in it] == [0, 1, 2, 3, 4]
