"""Actor semantics: creation, calls, ordering, named actors, death,
restart. Modeled on python/ray/tests/test_actor*.py."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError, ActorError


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, k=1):
        self.n += k
        return self.n

    def value(self):
        return self.n

    def fail(self):
        raise RuntimeError("actor method failure")

    def die(self):
        import os
        os._exit(1)


def test_actor_basic(ray_start):
    c = Counter.remote(10)
    assert ray_tpu_torch.get(c.inc.remote()) == 11
    assert ray_tpu_torch.get(c.inc.remote(5)) == 16
    assert ray_tpu_torch.get(c.value.remote()) == 16


def test_actor_method_ordering(ray_start):
    c = Counter.remote()
    refs = [c.inc.remote() for _ in range(50)]
    assert ray_tpu_torch.get(refs) == list(range(1, 51))


def test_actor_method_error(ray_start):
    c = Counter.remote()
    with pytest.raises(ActorError, match="actor method failure"):
        ray_tpu_torch.get(c.fail.remote())
    # Actor still alive after a method error.
    assert ray_tpu_torch.get(c.inc.remote()) == 1


def test_actor_init_error(ray_start):
    @ray_tpu_torch.remote
    class Bad:
        def __init__(self):
            raise ValueError("bad init")

        def ping(self):
            return "pong"

    b = Bad.remote()
    with pytest.raises((ActorDiedError, ActorError)):
        ray_tpu_torch.get(b.ping.remote(), timeout=30)


def test_named_actor(ray_start):
    Counter.options(name="counter_test_named").remote(100)
    time.sleep(0.1)
    h = ray_tpu_torch.get_actor("counter_test_named")
    assert ray_tpu_torch.get(h.inc.remote()) == 101
    ray_tpu_torch.kill(h)


def test_get_actor_missing(ray_start):
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("never_created_actor")


def test_kill_actor(ray_start):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.inc.remote()) == 1
    ray_tpu_torch.kill(c)
    time.sleep(0.5)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(c.inc.remote(), timeout=30)


def test_actor_crash_detected(ray_start):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.inc.remote()) == 1
    c.die.remote()
    time.sleep(1.5)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(c.inc.remote(), timeout=30)


def test_actor_restart(ray_start):
    @ray_tpu_torch.remote(max_restarts=2)
    class Restartable:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def die(self):
            import os
            os._exit(1)

    a = Restartable.remote()
    assert ray_tpu_torch.get(a.inc.remote()) == 1
    a.die.remote()
    time.sleep(2.0)
    # After restart, state resets but the actor answers again.
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            assert ray_tpu_torch.get(a.inc.remote(), timeout=30) == 1
            break
        except Exception:
            time.sleep(0.5)
    else:
        pytest.fail("actor did not come back after restart")


def test_handle_passing(ray_start):
    c = Counter.remote()

    @ray_tpu_torch.remote
    def bump(handle):
        return ray_tpu_torch.get(handle.inc.remote(7))

    assert ray_tpu_torch.get(bump.remote(c)) == 7
    assert ray_tpu_torch.get(c.value.remote()) == 7


def test_async_actor(ray_start):
    @ray_tpu_torch.remote(max_concurrency=10)
    class AsyncWorkder:
        async def work(self, t, tag):
            import asyncio
            await asyncio.sleep(t)
            return tag

    a = AsyncWorkder.remote()
    ray_tpu_torch.get(a.work.remote(0.0, -1))   # warm up (worker spawn)
    t0 = time.time()
    refs = [a.work.remote(1.0, i) for i in range(5)]
    assert sorted(ray_tpu_torch.get(refs)) == list(range(5))
    # Concurrent, not serial: 5 x 1s sleeps well under 4s total.
    assert time.time() - t0 < 4.0


def test_actor_concurrency_threads(ray_start):
    @ray_tpu_torch.remote(max_concurrency=4)
    class Sleeper:
        def nap(self, t):
            time.sleep(t)
            return "ok"

    s = Sleeper.remote()
    ray_tpu_torch.get(s.nap.remote(0.0))        # warm up (worker spawn)
    t0 = time.time()
    ray_tpu_torch.get([s.nap.remote(1.0) for _ in range(4)])
    assert time.time() - t0 < 3.5
