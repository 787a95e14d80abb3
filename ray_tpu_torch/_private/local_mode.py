"""Local mode: eager in-process execution (no subprocesses).

Reference parity: ray.init(local_mode=True) — tasks execute synchronously
at submission, actors are plain in-process instances. Used for debugging
and for fast library tests on constrained machines.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, Dict, Optional, Tuple

from .object_ref import ObjectRef
from ..exceptions import (ActorDiedError, ActorError, GetTimeoutError,
                          TaskError)
import traceback


class _LocalRefCounter:
    def add_local_ref(self, *a, **k): pass
    def remove_local_ref(self, *a, **k): pass
    def register_owned(self, *a, **k): pass
    def pin(self, *a, **k): pass
    def unpin(self, *a, **k): pass
    def on_borrower_event(self, *a, **k): pass


class LocalActorState:
    def __init__(self, instance):
        self.instance = instance
        self.dead = False
        self.death_cause = ""


class _LocalGenerator:
    """Eager local-mode stand-in for ObjectRefGenerator: all items were
    produced at submission; iteration just walks the refs."""

    def __init__(self, refs):
        self._refs = list(refs)
        self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._cursor >= len(self._refs):
            raise StopIteration
        ref = self._refs[self._cursor]
        self._cursor += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return self.__next__()
        except StopIteration:
            raise StopAsyncIteration

    def completed(self):
        return list(self)


class LocalModeClient:
    is_local_mode = True

    def __init__(self, namespace: str = "default"):
        self.namespace = namespace
        self.ref_counter = _LocalRefCounter()
        self.store: Dict[str, Any] = {}
        self.errors: Dict[str, Exception] = {}
        self.actors: Dict[str, LocalActorState] = {}
        self.named: Dict[Tuple[str, str], str] = {}
        self.kv: Dict[str, bytes] = {}
        self.address = None
        self.is_shutdown = False
        self.placement_groups: Dict[str, Any] = {}

    # -- objects --

    def put(self, value: Any) -> ObjectRef:
        oid = uuid.uuid4().hex
        self.store[oid] = value
        return ObjectRef(oid, None, _client=self)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        out = []
        for r in ref_list:
            if r.id in self.errors:
                raise self.errors[r.id]
            if r.id not in self.store:
                raise GetTimeoutError(f"object {r.id[:12]} never produced "
                                      "(local mode is eager)")
            out.append(self.store[r.id])
        return out[0] if single else out

    async def aio_get(self, ref: ObjectRef, deadline=None):
        return self.get(ref)

    def as_future(self, ref):
        import concurrent.futures
        f = concurrent.futures.Future()
        try:
            f.set_result(self.get(ref))
        except Exception as e:
            f.set_exception(e)
        return f

    def wait(self, refs, num_returns: int = 1, timeout=None):
        refs = list(refs)
        return refs[:num_returns], refs[num_returns:]

    # -- tasks --

    def _resolve(self, obj):
        if isinstance(obj, ObjectRef):
            return self.get(obj)
        return obj

    def _run_streaming(self, fn_name: str, result) -> "_LocalGenerator":
        refs = []
        try:
            if hasattr(result, "__anext__"):     # async generator parity
                async def _drain():
                    return [item async for item in result]
                items = asyncio.new_event_loop().run_until_complete(_drain())
            else:
                items = list(result)
            for item in items:
                oid = uuid.uuid4().hex
                self.store[oid] = item
                refs.append(ObjectRef(oid, None, _client=self))
        except Exception:
            oid = uuid.uuid4().hex
            self.errors[oid] = TaskError(fn_name, traceback.format_exc())
            refs.append(ObjectRef(oid, None, _client=self))
        return _LocalGenerator(refs)

    def submit_task(self, fn, args, kwargs, opts, fn_blob=None,
                    fn_hash=None):
        num_returns = opts.get("num_returns") or 1
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 1
        oids = [uuid.uuid4().hex for _ in range(num_returns)]
        args = tuple(self._resolve(a) for a in args)
        kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        try:
            result = fn(*args, **kwargs)
            if streaming:
                return self._run_streaming(
                    getattr(fn, "__name__", "task"), result)
            if asyncio.iscoroutine(result):
                result = asyncio.new_event_loop().run_until_complete(result)
            if num_returns == 1:
                self.store[oids[0]] = result
            else:
                for oid, part in zip(oids, result):
                    self.store[oid] = part
        except Exception:
            err = TaskError(
                getattr(fn, "__name__", "task"), traceback.format_exc())
            for oid in oids:
                self.errors[oid] = err
        refs = [ObjectRef(oid, None, _client=self) for oid in oids]
        return refs[0] if num_returns == 1 else refs

    # -- actors --

    def create_actor(self, cls, args, kwargs, opts, cls_blob=None,
                     cls_hash=None):
        actor_id = uuid.uuid4().hex
        oid = uuid.uuid4().hex
        args = tuple(self._resolve(a) for a in args)
        kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        try:
            instance = cls(*args, **kwargs)
            self.actors[actor_id] = LocalActorState(instance)
            self.store[oid] = None
            name = opts.get("name")
            if name:
                self.named[(opts.get("namespace") or self.namespace, name)] = \
                    actor_id
        except Exception:
            self.errors[oid] = ActorDiedError(
                actor_id, f"__init__ failed:\n{traceback.format_exc()}")
            state = LocalActorState(None)
            state.dead = True
            state.death_cause = traceback.format_exc()
            self.actors[actor_id] = state
        return actor_id, ObjectRef(oid, None, _client=self)

    def submit_actor_task(self, actor_id, method, args, kwargs, opts):
        oid = uuid.uuid4().hex
        streaming = (opts or {}).get("num_returns") == "streaming"
        actor = self.actors.get(actor_id)
        if actor is None or actor.dead:
            self.errors[oid] = ActorDiedError(
                actor_id, actor.death_cause if actor else "unknown actor")
            return ObjectRef(oid, None, _client=self)
        args = tuple(self._resolve(a) for a in args)
        kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        try:
            result = getattr(actor.instance, method)(*args, **kwargs)
            if streaming:
                return self._run_streaming(method, result)
            if asyncio.iscoroutine(result):
                result = asyncio.new_event_loop().run_until_complete(result)
            self.store[oid] = result
        except Exception:
            self.errors[oid] = ActorError(method, traceback.format_exc())
        return ObjectRef(oid, None, _client=self)

    def kill_actor(self, actor_id, no_restart=True):
        actor = self.actors.get(actor_id)
        if actor:
            actor.dead = True
            actor.death_cause = "killed"
            for key, aid in list(self.named.items()):
                if aid == actor_id:
                    del self.named[key]

    def get_actor_handle_info(self, name, namespace):
        actor_id = self.named.get((namespace or self.namespace, name))
        if actor_id is None:
            return None
        return {"actor_id": actor_id, "state": "ALIVE", "addr": None}

    # -- cluster --

    def cluster_resources(self):
        import os
        return {"CPU": float(os.cpu_count() or 1)}

    def available_resources(self):
        return self.cluster_resources()

    def nodes(self):
        return [{"node_id": "local", "alive": True,
                 "resources_total": self.cluster_resources(),
                 "resources_available": self.cluster_resources(),
                 "addr": None, "labels": {}}]

    def kv_put(self, key, value, overwrite=True):
        if not overwrite and key in self.kv:
            return False
        self.kv[key] = value
        return True

    def kv_get(self, key):
        return self.kv.get(key)

    def kv_del(self, key):
        return self.kv.pop(key, None) is not None

    def kv_keys(self, prefix=""):
        return [k for k in self.kv if k.startswith(prefix)]

    def shutdown(self):
        self.is_shutdown = True
