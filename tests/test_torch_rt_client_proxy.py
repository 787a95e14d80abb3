"""Ray-Client-equivalent proxy: a thin client in a separate process
drives the cluster over ONE connection (reference parity:
python/ray/util/client — init("ray://…") client mode)."""

import os
import subprocess
import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import start_client_proxy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


CLIENT_CODE = """
import ray_tpu_torch
ray_tpu_torch.init(address="client://{addr}")

# objects
ref = ray_tpu_torch.put({{"msg": "hello", "xs": [1, 2, 3]}})
assert ray_tpu_torch.get(ref)["msg"] == "hello"

# tasks, including a proxied ref as an argument
@ray_tpu_torch.remote
def add(a, b):
    return a + b

forty = ray_tpu_torch.put(40)
assert ray_tpu_torch.get(add.remote(forty, 2)) == 42
refs = [add.remote(i, i) for i in range(4)]
ready, pending = ray_tpu_torch.wait(refs, num_returns=4, timeout=60)
assert len(ready) == 4 and not pending
assert ray_tpu_torch.get(refs) == [0, 2, 4, 6]

# actors
@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.n = start
    def incr(self, k=1):
        self.n += k
        return self.n

c = Counter.remote(100)
assert ray_tpu_torch.get(c.incr.remote(5)) == 105
assert ray_tpu_torch.get(c.incr.remote()) == 106
ray_tpu_torch.kill(c)

# cluster introspection through the proxy
assert ray_tpu_torch.cluster_resources().get("CPU", 0) > 0
assert any(n["alive"] for n in ray_tpu_torch.nodes())
print("CLIENT_PROXY_OK")
ray_tpu_torch.shutdown()
"""


def test_thin_client_end_to_end(ray_start):
    host, port = start_client_proxy(port=0)
    code = CLIENT_CODE.format(addr=f"{host}:{port}")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert "CLIENT_PROXY_OK" in out.stdout, (out.stdout,
                                             out.stderr[-2000:])


def test_released_ref_rejected(ray_start):
    from ray_tpu_torch._private.client_proxy import ProxyModeClient

    host, port = start_client_proxy(port=0)
    client = ProxyModeClient(host, port)
    try:
        ref = client.put(123)
        assert client.get(ref) == 123
        rid = ref.id
        del ref                      # zero local refs -> release RPC
        import time
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                client._scall("client_get", ref_ids=[rid], timeout=1)
            except Exception:
                break                # released server-side
            time.sleep(0.2)
        else:
            raise AssertionError("released ref still served")
    finally:
        client.shutdown()


def test_nested_refs_and_typed_errors(ray_start):
    """Refs nested in returned values are pinned server-side and usable;
    typed errors (TaskError) survive the proxy boundary."""
    from ray_tpu_torch._private.client_proxy import ProxyModeClient
    from ray_tpu_torch.exceptions import TaskError

    host, port = start_client_proxy(port=0)
    client = ProxyModeClient(host, port)
    try:
        def make_refs():
            import ray_tpu_torch
            return [ray_tpu_torch.put(10), ray_tpu_torch.put(20)]

        outer = client.submit_task(make_refs, (), {}, {})
        inner_refs = client.get(outer)
        assert [client.get(r) for r in inner_refs] == [10, 20]

        def boom():
            raise ValueError("intentional proxy boom")

        bad = client.submit_task(boom, (), {}, {})
        with pytest.raises(TaskError, match="intentional proxy boom"):
            client.get(bad)
    finally:
        client.shutdown()
