"""Native C++ arena store: allocator, refcounts, eviction, integration.

Modeled on the reference's plasma tests
(src/ray/object_manager/plasma/test/, python/ray/tests/test_plasma*).
"""

import os

import numpy as np
import pytest

from ray_tpu_torch._native.arena import Arena, available

pytestmark = pytest.mark.skipif(
    not available(), reason="native arena lib unavailable")


@pytest.fixture()
def arena():
    name = f"rtpu_test_{os.getpid()}_{np.random.randint(1 << 30)}"
    a = Arena.create(name, 16 << 20)
    assert a is not None
    yield a
    a.unlink()
    a.detach()


def oid(i: int) -> str:
    return f"{i:032x}"


def test_create_seal_get_roundtrip(arena):
    buf = arena.create_buffer(oid(1), 100)
    buf[:100] = bytes(range(100))
    buf.release()
    arena.seal(oid(1))
    ref = arena.get(oid(1))
    assert bytes(ref.buf[:100]) == bytes(range(100))
    assert ref.size == 100
    ref.release()


def test_unsealed_invisible_duplicate_rejected(arena):
    arena.create_buffer(oid(2), 10)
    assert arena.get(oid(2)) is None
    assert not arena.contains(oid(2))
    assert arena.create_buffer(oid(2), 10) is None   # duplicate id
    arena.seal(oid(2))
    assert arena.contains(oid(2))


def test_cross_process_visibility(arena):
    import subprocess
    import sys

    buf = arena.create_buffer(oid(3), 8)
    buf[:8] = b"abcdefgh"
    buf.release()
    arena.seal(oid(3))
    code = (
        "from ray_tpu_torch._native.arena import Arena\n"
        f"a = Arena.attach({arena.name!r})\n"
        f"ref = a.get({oid(3)!r})\n"
        "print(bytes(ref.buf[:8]).decode())\n"
        "ref.release(); a.detach()\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=60, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    assert "abcdefgh" in out.stdout, out.stderr[-2000:]


def test_delete_frees_and_coalesces(arena):
    cap = arena.stats()["heap_capacity"]
    # fill with several blocks, delete them all, then allocate one block
    # nearly the full heap — only possible if adjacent frees coalesce
    n = 8
    per = (cap // n) - 4096
    for i in range(n):
        assert arena.create_buffer(oid(10 + i), per) is not None
        arena.seal(oid(10 + i))
    assert arena.create_buffer(oid(99), per) is None     # full
    for i in range(n):
        assert arena.delete(oid(10 + i))
    big = arena.create_buffer(oid(99), int(cap * 0.9))
    assert big is not None


def test_eviction_lru_order_and_refcount_pin(arena):
    a_id, b_id, c_id = oid(20), oid(21), oid(22)
    for i, x in enumerate((a_id, b_id, c_id)):
        buf = arena.create_buffer(x, 1 << 20)
        buf.release()
        arena.seal(x)
    # touch a (most recent), pin b
    arena.get(a_id).release()
    pinned = arena.get(b_id)
    reclaimed, ids = arena.evict(1 << 20)
    assert reclaimed >= 1 << 20
    assert ids[0] == c_id            # LRU victim, not the pinned/recent
    assert arena.contains(b_id)      # pinned survived
    pinned.release()


def test_stats_track_allocation(arena):
    before = arena.stats()
    buf = arena.create_buffer(oid(30), 4096)
    buf.release()
    after = arena.stats()
    assert after["num_objects"] == before["num_objects"] + 1
    assert after["bytes_allocated"] > before["bytes_allocated"]


def test_native_operation_counters(arena):
    """The C++ side maintains operation counters (native stats source
    feeding the /metrics node gauges — reference role:
    src/ray/stats/metric_defs.h)."""
    before = arena.stats()
    a_id, b_id = oid(40), oid(41)
    for i in (a_id, b_id):
        arena.create_buffer(i, 4096).release()
        arena.seal(i)
    arena.delete(a_id)
    arena.delete(b_id)
    # a fresh alloc after two adjacent frees exercises coalescing
    arena.create_buffer(oid(42), 8192).release()
    after = arena.stats()
    assert after["allocs"] >= before["allocs"] + 3
    assert after["frees"] >= before["frees"] + 2
    # fresh per-test arena: a+b sit adjacent at the heap start, so the
    # 8192 alloc MUST have merged their freed blocks
    assert after["coalesces"] > before["coalesces"]
    assert after["alloc_fails"] == before["alloc_fails"]
    # an impossible allocation bumps the failure counter, not a crash
    assert arena.create_buffer(oid(43), 1 << 40) is None
    assert arena.stats()["alloc_fails"] > after["alloc_fails"]


def test_runtime_integration_put_get_numpy():
    """Objects over the inline limit must travel through the arena and
    deserialize zero-copy."""
    import ray_tpu_torch
    from ray_tpu_torch._private.object_store import arena_name_for

    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=False)
    try:
        session = ray_tpu_torch.current_runtime().client.session_name
        arr = np.arange(1 << 20, dtype=np.float32)   # 4 MB
        ref = ray_tpu_torch.put(arr)
        out = ray_tpu_torch.get(ref)
        np.testing.assert_array_equal(out, arr)
        arena = Arena.attach(arena_name_for(session))
        assert arena is not None, "arena was not created by the daemon"
        assert arena.stats()["num_objects"] >= 1

        @ray_tpu_torch.remote
        def echo_sum(a):
            return float(a.sum())

        assert ray_tpu_torch.get(echo_sum.remote(ref)) == float(arr.sum())
        arena.detach()
    finally:
        ray_tpu_torch.shutdown()


def test_runtime_fallback_without_native():
    """RAY_TPU_DISABLE_NATIVE_ARENA falls back to per-object segments."""
    import subprocess
    import sys

    code = """
import os
os.environ["RAY_TPU_DISABLE_NATIVE_ARENA"] = "1"
import numpy as np
import ray_tpu_torch
ray_tpu_torch.init(num_cpus=2)
arr = np.arange(1 << 18, dtype=np.float32)
ref = ray_tpu_torch.put(arr)
np.testing.assert_array_equal(ray_tpu_torch.get(ref), arr)
ray_tpu_torch.shutdown()
print("FALLBACK_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], timeout=120,
                         capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert "FALLBACK_OK" in out.stdout, out.stderr[-2000:]


def test_delete_defers_while_pinned(arena):
    """Deleting a pinned object must not free the block under the
    reader's zero-copy view."""
    buf = arena.create_buffer(oid(40), 1024)
    buf[:4] = b"data"
    buf.release()
    arena.seal(oid(40))
    ref = arena.get(oid(40))
    before = arena.stats()["bytes_allocated"]
    assert arena.delete(oid(40))            # deferred: reader pinned
    assert arena.stats()["bytes_allocated"] == before
    assert arena.get(oid(40)) is None       # invisible to new gets
    assert bytes(ref.buf[:4]) == b"data"    # view still valid
    ref.release()                            # last release reclaims
    assert arena.stats()["bytes_allocated"] < before


def test_create_rejects_undersized_segment():
    a = Arena.create(f"rtpu_tiny_{os.getpid()}", 65536, capacity=4096)
    assert a is None                         # table would not fit
