"""Multi-node (fake cluster), resource scheduling, KV, local mode.

Modeled on python/ray/tests using cluster_utils.Cluster (reference
python/ray/cluster_utils.py:135): extra in-process node daemons with real
worker subprocesses."""

import time

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_local():
    ray_tpu_torch.init(local_mode=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_local_mode(ray_local):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1)) == 2

    @ray_tpu_torch.remote
    class A:
        def __init__(self):
            self.v = 5

        def get(self):
            return self.v

    a = A.remote()
    assert ray_tpu_torch.get(a.get.remote()) == 5


def test_kv_store(ray_start):
    client = ray_tpu_torch._private.state.current_client()
    assert client.kv_put("k1", b"v1")
    assert client.kv_get("k1") == b"v1"
    assert client.kv_get("nope") is None
    assert "k1" in client.kv_keys("k")
    assert client.kv_del("k1")
    assert client.kv_get("k1") is None


def test_custom_resources_schedule(ray_start):
    node_id = ray_tpu_torch.add_fake_node(num_cpus=2,
                                    resources={"accel_test": 4.0})
    try:
        @ray_tpu_torch.remote(resources={"accel_test": 2.0})
        def where():
            return ray_tpu_torch.get_runtime_context().get_node_id()

        assert ray_tpu_torch.get(where.remote(), timeout=60) == node_id
    finally:
        ray_tpu_torch.remove_node(node_id)


def test_node_death_fails_running_task(ray_start):
    node_id = ray_tpu_torch.add_fake_node(num_cpus=1,
                                    resources={"doomed": 1.0})

    @ray_tpu_torch.remote(resources={"doomed": 1.0})
    def stuck():
        time.sleep(60)
        return "never"

    ref = stuck.remote()
    time.sleep(2.0)  # let it start on the doomed node
    ray_tpu_torch.remove_node(node_id)
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=30)


def test_queued_task_runs_when_resources_free(ray_start):
    # 8 CPUs total; a 6-CPU task plus a queued 6-CPU task must serialize.
    @ray_tpu_torch.remote(num_cpus=6)
    def hold(t):
        time.sleep(t)
        return time.time()

    t0 = time.time()
    a = hold.remote(1.5)
    b = hold.remote(0.1)
    ta, tb = ray_tpu_torch.get([a, b], timeout=90)
    assert tb > ta - 0.05, "second task should start after the first finishes"
    assert time.time() - t0 >= 1.5


def test_available_resources_reflect_usage(ray_start):
    @ray_tpu_torch.remote(num_cpus=4)
    def hold():
        time.sleep(2.0)
        return True

    ref = hold.remote()
    time.sleep(1.0)
    avail = ray_tpu_torch.available_resources()
    total = ray_tpu_torch.cluster_resources()
    assert total["CPU"] - avail.get("CPU", 0) >= 4
    ray_tpu_torch.get(ref)
