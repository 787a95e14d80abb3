"""ray_tpu_torch.util.thread_sanitizer and the port's engine under it:
the cases of tests/test_thread_sanitizer.py on the port (CPU), plus the
public ``lane_counts()`` against ``stats()["lanes"]`` and the JAX
engine's, and the traced re-entrant lock of a CUDA device.

Unit half: disarmed make_lock is a plain threading.Lock (a re-entrant
one is the device's own RLock), armed locks detect order inversions and
owner re-acquisition, guarded_by descriptors check lock ownership with
an unguarded() escape hatch; the traced re-entrant lock re-enters
cleanly, counts its depth and feeds the order graph under the device's
name.

Stress half: the real engine hammered from concurrent threads (stats /
lane_counts / session_ids / fleet_counters / has_work / abort / preempt
/ export_session of unknown ids) while the pump steps 200 guarded ticks,
the sanitizer armed the whole time: one readback a tick, no upload, no
capture, zero violations, and tokens equal to a single-threaded run's.

One departure from the JAX file: the pump of
``test_concurrent_adds_never_lost`` steps until a deadline, not for a
fixed 400 steps: under the suite's worker load a step budget can run
out before the adds land, which fails the test without a lost add.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.util import thread_sanitizer as ts
from ray_tpu_torch.util.dispatch_guard import dispatch_guard

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    ts.disarm()
    ts.reset()


# ------------------------------------------------------------- unit: locks

def test_disarmed_make_lock_is_plain_lock():
    lock = ts.make_lock("x")
    assert type(lock) is type(threading.Lock())
    inner = threading.RLock()
    assert ts.make_lock("r", reentrant=True, inner=inner) is inner
    assert type(ts.make_lock("r", reentrant=True)) is type(inner)
    # the engine's locks: plain per CPU engine, the device's RLock on CUDA
    assert type(te.make_lock(torch.device("cpu"))) is type(threading.Lock())
    dev = torch.device("cuda", 5)
    assert te.make_lock(dev) is te._DEVICE_LOCKS[5]


def test_armed_make_lock_traces():
    ts.arm()
    lock = ts.make_lock("x")
    assert isinstance(lock, ts._TracedLock)
    with lock:
        assert lock.held_by_me()
    assert not lock.held_by_me()


def test_lock_order_inversion_detected():
    ts.reset()
    ts.arm()
    a, b = ts.make_lock("a"), ts.make_lock("b")
    with a:
        with b:
            pass
    assert ts.violations() == []
    with b:
        with a:
            pass
    got = ts.violations()
    assert len(got) == 1
    assert "inversion" in got[0]
    with pytest.raises(AssertionError):
        ts.assert_clean()


def test_consistent_order_clean():
    ts.reset()
    ts.arm()
    a, b = ts.make_lock("a"), ts.make_lock("b")
    for _ in range(3):
        with a:
            with b:
                pass
    assert ts.violations() == []


def test_owner_reacquisition_reported_not_deadlocked():
    ts.reset()
    ts.arm()
    lock = ts.make_lock("x")
    with lock:
        # a real threading.Lock would deadlock here forever; the
        # traced lock records the bug and declines the acquisition
        assert lock.acquire(timeout=0.1) is False
    got = ts.violations()
    assert len(got) == 1
    assert "re-acquisition" in got[0]


def test_strict_mode_raises_on_violating_thread():
    ts.reset()
    ts.arm(strict=True)
    lock = ts.make_lock("x")
    with lock:
        with pytest.raises(AssertionError):
            lock.acquire()
    ts.disarm()


def test_traced_reentrant_device_lock():
    """The device's traced lock: the owner re-enters cleanly, the depth
    counts, each re-entry is counted by the function that made it, the
    order graph names the device, and the inner RLock is the one the
    device's disarmed engines hold, so they still exclude each other."""
    ts.reset()
    dev = torch.device("cuda", 6)
    plain = te.make_lock(dev)
    ts.arm()
    lock = te.make_lock(dev)
    assert isinstance(lock, ts._TracedRLock)
    assert lock.name == "engine._step_lock[cuda:6]"
    assert te.make_lock(dev) is lock          # one traced lock a device
    other = ts.make_lock("fleet._lock")

    def nested():
        with lock:
            assert lock.depth == 2

    with lock:
        assert lock.held_by_me() and lock.depth == 1
        nested()
        assert lock.depth == 1
        with other:
            pass
    assert not lock.held_by_me() and lock.depth == 0 and not lock.locked()
    assert lock.reentry_sites == {"test_traced_reentrant_device_lock."
                                  "<locals>.nested": 1}
    assert ts.order_edges() == {
        ("engine._step_lock[cuda:6]", "fleet._lock"): "MainThread"}
    assert ts.violations() == []
    # a disarmed engine's hold of the device lock excludes the traced one
    got = []
    with plain:
        t = threading.Thread(
            target=lambda: got.append(lock.acquire(timeout=0.05)))
        t.start()
        t.join(5)
    assert got == [False]
    with pytest.raises(RuntimeError):
        lock.release()                        # not held by this thread
    # the reverse order is an inversion under the device's name
    with other:
        with lock:
            pass
    got = ts.violations()
    assert len(got) == 1 and "engine._step_lock[cuda:6]" in got[0]


# -------------------------------------------------------- unit: guarded_by

class _Box:
    items = ts.guarded_by("_lock")
    log = ts.guarded_by("_lock", writes_only=True)

    def __init__(self):
        self._lock = ts.make_lock("box._lock")
        with self._lock:
            self.items = []
            self.log = []


def test_guarded_field_checks_only_when_armed():
    box = _Box()          # disarmed: plain lock, no checks ever
    box.items = [1]
    assert box.items == [1]
    ts.arm()              # lock is still a plain Lock -> still no checks
    box.items = [2]
    assert ts.violations() == []


def test_guarded_field_armed_write_without_lock():
    ts.reset()
    ts.arm()
    box = _Box()
    box.items = [1]                   # unguarded write
    _ = box.items                     # unguarded read
    box.log = []                      # write-guarded too
    _ = box.log                       # ...but reads of log are free
    got = ts.violations()
    assert len(got) == 3
    assert any("write of _Box.items" in v for v in got)
    assert any("read of _Box.items" in v for v in got)
    assert any("write of _Box.log" in v for v in got)


def test_guarded_field_clean_under_lock_and_unguarded():
    ts.reset()
    ts.arm()
    box = _Box()
    with box._lock:
        box.items = [1]
        assert box.items == [1]
    with ts.unguarded():              # the blackbox crash-path escape
        assert box.items == [1]
        box.items = [2]
    assert ts.violations() == []


def test_guarded_field_wrong_thread_detected():
    ts.reset()
    ts.arm()
    box = _Box()
    hold = threading.Event()
    release = threading.Event()

    def holder():
        with box._lock:
            hold.set()
            release.wait(5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    hold.wait(5)
    box.items = [9]       # lock is held -- by ANOTHER thread
    release.set()
    t.join(5)
    assert any("write of _Box.items" in v for v in ts.violations())


def test_sanitized_scope_resets_and_disarms():
    with ts.sanitized():
        assert ts.armed()
        lock = ts.make_lock("y")
        with lock:
            lock.acquire(timeout=0.01)
    assert not ts.armed()
    assert len(ts.violations()) == 1   # survives for inspection
    ts.reset()
    assert ts.violations() == []


# --------------------------------------------- engine regression: snapshots

def _engine(**over):
    kw = dict(model=tl.config("debug", dtype=torch.float32), device="cpu",
              max_batch_size=4, page_size=8, num_pages=160,
              prefill_buckets=(16, 32, 64), seed=7, unified_step=True)
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw))


def _requests(n=3, max_tokens=256, mod=te):
    rng = np.random.default_rng(11)
    return [mod.Request(f"g{i}", rng.integers(2, 250, 12).tolist(),
                        mod.SamplingParams(max_tokens=max_tokens))
            for i in range(n)]


def test_fleet_counters_published_snapshot():
    """fleet_counters() is the lock-free read the fleet scrape path
    uses: every mutating entry point republishes a FRESH dict (the old
    snapshot stays internally consistent for whoever holds it)."""
    eng = _engine()
    snap0 = eng.fleet_counters()
    assert snap0["waiting"] == 0 and snap0["active"] == 0
    req = _requests(1, max_tokens=16)[0]
    eng.add_request(req)
    snap1 = eng.fleet_counters()
    assert snap1 is not snap0          # replaced, not mutated
    assert snap0["waiting"] == 0       # old snapshot untouched
    assert snap1["waiting"] == 1
    while not req.finished:
        eng.step()
    snap2 = eng.fleet_counters()
    assert snap2["active"] == 0 and snap2["waiting"] == 0
    assert set(snap2) == {"active", "waiting", "parked_sessions",
                          "preemptions_total", "page_pressure", "lanes"}


def test_concurrent_adds_never_lost():
    """The race an unlocked add_request would lose: step() rebinds
    `waiting` to the survivors list mid-tick, and an append landing on
    the discarded list would vanish. Locked add_request makes every add
    stick, whatever the interleaving. The pump steps until the adds are
    done or a deadline passes (not a fixed step budget)."""
    eng = _engine(num_pages=256, max_batch_size=8)
    reqs = _requests(12, max_tokens=8)
    errs = []
    deadline = time.monotonic() + 120

    def pump():
        try:
            while time.monotonic() < deadline:
                eng.step()
                if all(r.finished for r in reqs):
                    return
        except BaseException as exc:   # pragma: no cover
            errs.append(exc)

    t = threading.Thread(target=pump)
    t.start()
    for r in reqs:
        eng.add_request(r)
    t.join(150)
    assert not errs
    assert all(r.finished for r in reqs)
    assert all(len(r.output_tokens) == 8 for r in reqs)


def test_stats_consistent_under_concurrent_steps():
    """stats()/lane_counts() snapshot under ONE lock acquisition: no
    RuntimeError from iterating the tick deque / preempt dict
    mid-mutation, and the per-call view is internally consistent."""
    eng = _engine()
    reqs = _requests(3, max_tokens=64)
    for r in reqs:
        eng.add_request(r)
    errs = []
    stop = threading.Event()

    def scrape():
        try:
            while not stop.is_set():
                s = eng.stats()
                assert s["waiting"] >= 0
                assert s["tick_times"]["window"] >= 0
                eng.lane_counts()
                eng.session_ids()
        except BaseException as exc:
            errs.append(exc)

    threads = [threading.Thread(target=scrape, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    try:
        while not all(r.finished for r in reqs):
            eng.step()
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not errs, errs


def test_lane_counts_public_matches_stats_and_jax():
    """The public lane_counts() snapshots what stats()["lanes"] and the
    published fleet counters carry, and equals the JAX engine's
    lane_counts() on the same requests at each point of the drive."""
    import jax.numpy as jnp
    from ray_tpu.llm import EngineConfig as JConfig
    from ray_tpu.llm import InferenceEngine as JEngine
    from ray_tpu.llm import Request as JRequest
    from ray_tpu.llm import SamplingParams as JSamplingParams
    from ray_tpu.models import llama as jl

    eng = _engine(max_batch_size=2)
    jeng = JEngine(JConfig(model=jl.config("debug", dtype=jnp.float32),
                           max_batch_size=2, page_size=8, num_pages=160,
                           prefill_buckets=(16, 32, 64), seed=7,
                           unified_step=True))
    sides = []
    for e, mod in ((eng, te),
                   (jeng, type("M", (), dict(Request=JRequest,
                                             SamplingParams=JSamplingParams)))):
        reqs = _requests(4, max_tokens=6, mod=mod)
        for i, r in enumerate(reqs):
            r.lane = "batch" if i % 2 == 0 else "interactive"
            e.add_request(r)
        seen = [e.lane_counts()]
        while not all(r.finished for r in reqs):
            e.step()
            seen.append(e.lane_counts())
        sides.append(seen)
        if e is eng:
            assert eng.lane_counts() == eng.stats()["lanes"] \
                == eng.fleet_counters()["lanes"]
    assert sides[0][0] == {"waiting_batch": 2, "active_batch": 0,
                           "parked_batch": 0, "batch_kv_pages": 0}
    n = min(len(sides[0]), len(sides[1]))
    assert sides[0][:n] == sides[1][:n]
    assert sides[0][-1] == sides[1][-1]


def test_armed_engine_guards_its_fields():
    """Armed, the engine's step lock is traced and its guarded fields
    report a write without it; the black box's bare read of the tick
    deque is sanctioned."""
    ts.reset()
    ts.arm()
    eng = _engine(enable_blackbox=False)
    assert isinstance(eng._step_lock, ts._TracedLock)
    reqs = _requests(1, max_tokens=4)
    eng.add_request(reqs[0])
    while not reqs[0].finished:
        eng.step()
    eng.stats()
    eng.lane_counts()
    with ts.unguarded():
        list(eng._tick_times)
    assert ts.violations() == []
    eng.waiting = []
    eng._pending_touched = []
    list(eng._tick_times)
    got = ts.violations()
    assert len(got) == 3, got
    assert {v.split(" on thread")[0] for v in got} == {
        "unguarded write of InferenceEngine.waiting",
        "unguarded write of InferenceEngine._pending_touched",
        "unguarded read of InferenceEngine._tick_times"}


# ----------------------------------------------------- the armed stress gate

def _oracle_tokens(n_req, max_tokens):
    eng = _engine()
    reqs = _requests(n_req, max_tokens)
    for r in reqs:
        eng.add_request(r)
    while not all(r.finished for r in reqs):
        eng.step()
    return {r.request_id: list(r.output_tokens) for r in reqs}


def _armed_stress(n_req, max_tokens, guarded_ticks):
    want = _oracle_tokens(n_req, max_tokens)

    with ts.sanitized():
        eng = _engine()     # created armed: traced step lock
        assert isinstance(eng._step_lock, ts._TracedLock)
        reqs = _requests(n_req, max_tokens)
        for r in reqs:
            eng.add_request(r)
        # warmup: admit + prefill + settle into steady pipelined decode
        while eng.waiting or any(s.request is not None and not s.ready
                                 for s in eng.slots):
            eng.step()
        for _ in range(4):
            eng.step()

        stop = threading.Event()
        errs = []
        calls = [0]

        def hammer():
            # every lock-taking, host-only entry point the serving plane
            # calls concurrently with the pump; unknown ids, so no
            # structural event lands inside the guarded window
            try:
                while not stop.is_set():
                    eng.stats()
                    eng.lane_counts()
                    eng.session_ids()
                    eng.fleet_counters()
                    eng.has_work()
                    assert eng.abort("no-such-id") is False
                    assert eng.preempt("no-such-id") is False
                    assert eng.export_session("no-such-id") is None
                    calls[0] += 1
            except BaseException as exc:
                errs.append(exc)

        threads = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        d0, c0 = eng.dispatches, eng.compiles
        try:
            with dispatch_guard(engine=eng) as rep:
                for _ in range(guarded_ticks):
                    eng.step()
        finally:
            stop.set()
            for t in threads:
                t.join(60)
        assert not errs, errs
        assert calls[0] > 0
        # one dispatch and one readback a tick, no upload, no capture,
        # no compile while three threads hammered every entry point
        assert eng.dispatches - d0 == guarded_ticks
        assert eng.compiles == c0
        assert rep.readbacks == guarded_ticks
        assert rep.uploads == [] and rep.captures == []
        # run the streams to completion (still armed)
        while not all(r.finished for r in reqs):
            eng.step()
        ts.assert_clean()

    got = {r.request_id: list(r.output_tokens) for r in reqs}
    assert got == want      # concurrency changed nothing observable


def test_armed_stress_token_exact_and_clean():
    """The JAX file's gate at its size (it carries `slow` there; here
    the whole case takes a few seconds on the CPU): 12-token prompts +
    240 <= max_seq 256, 240 decode ticks a stream keep every request
    live across the 200 guarded ticks. The card's run is chip_smoke.py's
    phase 5i."""
    _armed_stress(3, 240, 200)
