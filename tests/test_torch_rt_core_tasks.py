"""Task semantics: submit/get/wait/errors/nesting/retries.

Modeled on reference tests python/ray/tests/test_basic*.py.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import (GetTimeoutError, InfeasibleResourceError,
                                TaskError)


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_simple_task(ray_start):
    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    assert ray_tpu_torch.get(f.remote(21)) == 42


def test_many_parallel_tasks(ray_start):
    @ray_tpu_torch.remote
    def sq(x):
        return x * x

    refs = [sq.remote(i) for i in range(20)]
    assert ray_tpu_torch.get(refs) == [i * i for i in range(20)]


def test_task_error_propagates(ray_start):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("intentional")

    with pytest.raises(TaskError, match="intentional"):
        ray_tpu_torch.get(boom.remote())


def test_object_ref_args(ray_start):
    @ray_tpu_torch.remote
    def plus1(x):
        return x + 1

    a = plus1.remote(0)
    b = plus1.remote(a)       # ref as arg, resolved at worker
    c = plus1.remote(b)
    assert ray_tpu_torch.get(c) == 3


def test_put_and_pass(ray_start):
    ref = ray_tpu_torch.put({"k": [1, 2, 3]})

    @ray_tpu_torch.remote
    def read(d):
        return d["k"][-1]

    assert ray_tpu_torch.get(read.remote(ref)) == 3
    assert ray_tpu_torch.get(ref) == {"k": [1, 2, 3]}


def test_large_object_roundtrip(ray_start):
    arr = np.arange(1_000_000, dtype=np.float32)   # 4MB -> shm

    @ray_tpu_torch.remote
    def make():
        return np.arange(1_000_000, dtype=np.float32)

    out = ray_tpu_torch.get(make.remote())
    np.testing.assert_array_equal(out, arr)

    ref = ray_tpu_torch.put(arr * 2)

    @ray_tpu_torch.remote
    def total(x):
        return float(x.sum())

    assert ray_tpu_torch.get(total.remote(ref)) == float((arr * 2).sum())


def test_nested_tasks(ray_start):
    @ray_tpu_torch.remote
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) + 10

    assert ray_tpu_torch.get(outer.remote(0)) == 11


def test_wait(ray_start):
    @ray_tpu_torch.remote
    def fast():
        return "fast"

    @ray_tpu_torch.remote
    def slow():
        time.sleep(3)
        return "slow"

    s, f = slow.remote(), fast.remote()
    ready, not_ready = ray_tpu_torch.wait([s, f], num_returns=1, timeout=2.0)
    assert ready == [f]
    assert not_ready == [s]
    ready2, _ = ray_tpu_torch.wait([s], num_returns=1)
    assert ready2 == [s]


def test_get_timeout(ray_start):
    @ray_tpu_torch.remote
    def sleepy():
        time.sleep(5)

    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(sleepy.remote(), timeout=0.5)


def test_infeasible_resources(ray_start):
    @ray_tpu_torch.remote(num_cpus=10_000)
    def f():
        return 1

    with pytest.raises(InfeasibleResourceError):
        ray_tpu_torch.get(f.remote(), timeout=10)


def test_options_override(ray_start):
    @ray_tpu_torch.remote(num_cpus=10_000)
    def f():
        return "ran"

    assert ray_tpu_torch.get(f.options(num_cpus=1).remote()) == "ran"


def test_async_task_function(ray_start):
    @ray_tpu_torch.remote
    async def afn(x):
        return x * 3

    assert ray_tpu_torch.get(afn.remote(4)) == 12


def test_kwargs_and_defaults(ray_start):
    @ray_tpu_torch.remote
    def f(a, b=10, *, c=100):
        return a + b + c

    assert ray_tpu_torch.get(f.remote(1, c=2)) == 13


def test_cluster_resources_visible(ray_start):
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU", 0) >= 8
    nodes = ray_tpu_torch.nodes()
    assert len(nodes) >= 1 and nodes[0]["alive"]


def test_num_returns(ray_start):
    @ray_tpu_torch.remote(num_returns=3)
    def split():
        return 1, 2, 3

    a, b, c = split.remote()
    assert ray_tpu_torch.get([a, b, c]) == [1, 2, 3]

    @ray_tpu_torch.remote(num_returns=2)
    def bad():
        return 1  # not a 2-tuple

    with pytest.raises(TaskError, match="num_returns=2"):
        ray_tpu_torch.get(bad.remote()[0])


def test_task_burst_after_actor_creation(ray_start):
    """Regression: tasks queued behind actor-occupied workers must take
    the next FREED worker, not each block on a fresh worker spawn."""
    import time

    ray_tpu_torch = ray_start

    @ray_tpu_torch.remote
    def noop():
        return None

    @ray_tpu_torch.remote
    class Holder:
        def ping(self):
            return "ok"

    ray_tpu_torch.get([noop.remote() for _ in range(4)])
    holders = [Holder.remote() for _ in range(3)]
    assert ray_tpu_torch.get([h.ping.remote() for h in holders]) == ["ok"] * 3

    # warm the regrown pool (one-time spawn cost), then measure
    ray_tpu_torch.get([noop.remote() for _ in range(30)])
    t0 = time.monotonic()
    assert ray_tpu_torch.get([noop.remote() for _ in range(100)]) == [None] * 100
    elapsed = time.monotonic() - t0
    # pre-fix this took >10s (serial spawn per waiting task)
    assert elapsed < 8.0, f"task burst took {elapsed:.1f}s"
    for h in holders:
        ray_tpu_torch.kill(h)


def test_function_store_large_closure(ray_start):
    """Code blobs above fn_inline_limit ship once via the controller KV
    function store (fn_hash in the spec), not per-task (reference parity:
    _private/function_manager.py export + lazy import)."""
    big = bytes(range(256)) * 512        # 128 KiB captured constant

    @ray_tpu_torch.remote
    def fat(i):
        return len(big) + i

    # Repeated calls + a second worker-side deserialize all resolve
    # through the store/cache.
    assert ray_tpu_torch.get([fat.remote(i) for i in range(4)]) == [
        len(big) + i for i in range(4)]

    # The blob landed in the KV under its content hash.
    from ray_tpu_torch._private.core import FN_STORE_PREFIX
    from ray_tpu_torch._private.state import current_client
    keys = current_client().kv_keys(FN_STORE_PREFIX)
    assert keys, "expected an exported function blob in the KV store"


def test_function_store_large_actor_class(ray_start):
    table = {i: i * i for i in range(3000)}   # big captured state

    @ray_tpu_torch.remote
    class Fat:
        def lookup(self, i):
            return table[i]

    a = Fat.remote()
    assert ray_tpu_torch.get(a.lookup.remote(7)) == 49
