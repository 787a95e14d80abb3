"""Runtime thread sanitizer: the dynamic half of racelint.

A copy of ``ray_tpu/util/thread_sanitizer.py`` with one addition, a
traced re-entrant lock for the port's shared per-device step lock.
tools/racelint checks lock discipline statically; this module checks it
at RUNTIME in stress tests, at zero steady-state cost:

- `make_lock(name)` — returns a plain `threading.Lock` while the
  sanitizer is disarmed (the production default: no wrapper, no
  indirection, structurally overhead-free) and a traced lock while
  armed. The traced lock records each thread's acquisition ORDER into
  a global graph keyed by lock *name* and reports an inversion the
  moment two locks are ever taken in both orders — the deadlock that
  RL003 catches statically, caught here even across modules.
- `make_lock(name, reentrant=True, inner=lock)` — the same for a
  re-entrant lock: disarmed, `inner` itself (or a fresh
  `threading.RLock`); armed, a `_TracedRLock` that keeps the RLock's
  semantics over `inner`, counts its depth, answers `held_by_me()`,
  feeds the same order graph and counts its owner's re-entries by the
  function that re-entered (`reentry_sites`).
- `guarded_by("_step_lock")` — a data descriptor for engine-state
  fields: while armed, reads/writes check that the owning lock is
  held by the current thread and record a violation otherwise (the
  dynamic RL001/RL004). Disarmed, it is a `__dict__`-backed attribute
  with no checks. `unguarded()` marks a lock-free-by-contract scope
  (the blackbox crash path) so its sanctioned bare reads don't
  trip it.

Violations are RECORDED, not raised (strict=True raises): a stress
test hammers the engine from many threads and asserts
`assert_clean()` at the end, so one report shows every violation
rather than dying on the first.

Stdlib-only, imports nothing of the package (the engine imports us).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "arm", "disarm", "armed", "sanitized", "reset", "make_lock",
    "guarded_by", "unguarded", "violations", "assert_clean",
]


class _State:
    def __init__(self) -> None:
        self.armed = False
        self.strict = False
        self.lock = threading.Lock()           # guards the fields below
        self.violations: List[str] = []
        # lock-NAME order graph: edges (held -> acquired) with the
        # first thread/name pair that created each edge
        self.order: Dict[Tuple[str, str], str] = {}
        self.inverted: Set[Tuple[str, str]] = set()


_state = _State()
_tls = threading.local()


def _held_stack() -> List["_TracedLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _bypass_depth() -> int:
    return getattr(_tls, "bypass", 0)


def armed() -> bool:
    return _state.armed


def arm(strict: bool = False) -> None:
    """Arm the sanitizer for locks/fields created AFTER this call
    (and checks on already-guarded fields). strict=True raises on
    the violating thread instead of recording."""
    _state.armed = True
    _state.strict = strict


def disarm() -> None:
    _state.armed = False


def reset() -> None:
    """Clear recorded violations and the acquisition-order graph
    (per-test isolation)."""
    with _state.lock:
        _state.violations.clear()
        _state.order.clear()
        _state.inverted.clear()


def violations() -> List[str]:
    with _state.lock:
        return list(_state.violations)


def order_edges() -> Dict[Tuple[str, str], str]:
    """The acquisition-order graph: (held, acquired) lock names -> the
    thread that first took them in that order."""
    with _state.lock:
        return dict(_state.order)


def assert_clean() -> None:
    got = violations()
    if got:
        raise AssertionError(
            "thread sanitizer recorded %d violation(s):\n  %s"
            % (len(got), "\n  ".join(got)))


@contextlib.contextmanager
def sanitized(strict: bool = False):
    """Arm + reset for a scope; disarm on exit (violations survive
    for inspection)."""
    reset()
    arm(strict=strict)
    try:
        yield
    finally:
        disarm()


def _report(msg: str) -> None:
    with _state.lock:
        _state.violations.append(msg)
    if _state.strict:
        raise AssertionError(f"thread sanitizer: {msg}")


class _TracedLock:
    """threading.Lock with per-thread held-stack + global
    acquisition-order tracking. Non-reentrant, like the real thing —
    re-acquisition by the owner is reported (it would deadlock) and
    NOT attempted, so the sanitizer itself never wedges the test."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    # -- order graph ---------------------------------------------------
    def _check_order(self) -> None:
        me = threading.current_thread().name
        held = _held_stack()
        msgs = []
        # collect under _state.lock, report AFTER releasing — _report
        # re-takes _state.lock (non-reentrant), the very RL006 shape
        # this module exists to catch
        with _state.lock:
            for h in held:
                if h.name == self.name:
                    continue
                edge = (h.name, self.name)
                rev = (self.name, h.name)
                if edge not in _state.order:
                    _state.order[edge] = me
                if rev in _state.order and edge not in _state.inverted \
                        and rev not in _state.inverted:
                    _state.inverted.add(edge)
                    first = _state.order[rev]
                    msgs.append(
                        f"lock-order inversion: thread {me} acquires "
                        f"{self.name} while holding {h.name}, but "
                        f"thread {first} acquired them in the "
                        f"opposite order")
        for m in msgs:
            _report(m)

    # -- Lock API ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ident = threading.get_ident()
        if self._owner == ident:
            _report(f"re-acquisition of non-reentrant lock "
                    f"{self.name} by its owner thread "
                    f"{threading.current_thread().name} (deadlock)")
            return False
        self._check_order()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._owner = ident
            _held_stack().append(self)
        return ok

    def release(self) -> None:
        self._owner = None
        stack = _held_stack()
        if self in stack:
            stack.remove(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<_TracedLock {self.name} locked={self.locked()}>"


def _reentry_site() -> str:
    """The first function outside this module on the calling stack."""
    f = sys._getframe(1)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    return "?" if f is None else f.f_code.co_qualname


class _TracedRLock(_TracedLock):
    """A re-entrant lock with the traced lock's bookkeeping, over an
    inner `threading.RLock` (the one lock a device's engines share, so
    engines built disarmed and armed still exclude each other): the
    owner may re-acquire, each re-acquisition deepens `depth` and is
    counted by the function that made it, and only the outermost
    acquisition feeds the order graph and the held stack. A release by
    a thread that does not hold it raises RuntimeError, as the RLock's
    does."""

    def __init__(self, name: str, inner=None):
        super().__init__(name)
        self._lock = inner if inner is not None else threading.RLock()
        self.depth = 0
        self.reentry_sites: Dict[str, int] = {}

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._owner == threading.get_ident():
            self.depth += 1
            site = _reentry_site()
            self.reentry_sites[site] = self.reentry_sites.get(site, 0) + 1
            return True
        self._check_order()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._owner = threading.get_ident()
            self.depth = 1
            _held_stack().append(self)
        return ok

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError(f"cannot release {self.name}: not held by "
                               f"this thread")
        self.depth -= 1
        if self.depth:
            return
        self._owner = None
        stack = _held_stack()
        if self in stack:
            stack.remove(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._owner is not None

    @property
    def reentries(self) -> int:
        return sum(self.reentry_sites.values())

    def __repr__(self) -> str:
        return (f"<_TracedRLock {self.name} depth={self.depth} "
                f"reentries={self.reentries}>")


def make_lock(name: str, reentrant: bool = False, inner=None):
    """A lock for engine/fleet state. Disarmed (the default): exactly
    `threading.Lock()` — callers hold a plain stdlib lock with zero
    wrapper overhead — or, with `reentrant`, `inner` (else a fresh
    `threading.RLock()`). Armed: a traced lock that feeds the
    order-inversion detector and `guarded_by` ownership checks
    (re-entrant over `inner` with `reentrant`)."""
    if reentrant:
        if _state.armed:
            return _TracedRLock(name, inner)
        return inner if inner is not None else threading.RLock()
    if _state.armed:
        return _TracedLock(name)
    return threading.Lock()


@contextlib.contextmanager
def unguarded():
    """Mark the current thread's scope as lock-free-by-contract: a
    crash/forensics path that reads guarded fields WITHOUT the lock
    on purpose (engine.dump_blackbox). Guarded-field checks are
    skipped inside."""
    _tls.bypass = _bypass_depth() + 1
    try:
        yield
    finally:
        _tls.bypass -= 1


class guarded_by:
    """Data descriptor: `field = guarded_by("_step_lock")` makes
    reads+writes of `self.field` assert (record) that `self._step_lock`
    is held by the current thread — but ONLY while the sanitizer is
    armed AND the lock is a traced lock (production plain Locks can't
    answer "who holds me", and cost nothing). writes_only=True checks
    stores but not loads, for fields whose bare reads of a published
    reference are part of the design."""

    def __init__(self, lock_attr: str, writes_only: bool = False):
        self.lock_attr = lock_attr
        self.writes_only = writes_only
        self.name = "<unset>"
        self.slot = "<unset>"

    def __set_name__(self, owner, name: str) -> None:
        self.name = name
        self.slot = f"__guarded_{name}"

    def _check(self, obj, op: str) -> None:
        if not _state.armed or _bypass_depth():
            return
        lock = getattr(obj, self.lock_attr, None)
        if not isinstance(lock, _TracedLock):
            return      # plain production lock (or not created yet)
        if not lock.held_by_me():
            _report(
                f"unguarded {op} of {type(obj).__name__}.{self.name} "
                f"on thread {threading.current_thread().name} without "
                f"{self.lock_attr}")

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if not self.writes_only:
            self._check(obj, "read")
        try:
            return obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value) -> None:
        self._check(obj, "write")
        obj.__dict__[self.slot] = value

    def __delete__(self, obj) -> None:
        self._check(obj, "delete")
        del obj.__dict__[self.slot]
