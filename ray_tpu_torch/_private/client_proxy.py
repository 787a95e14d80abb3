"""Ray-Client-equivalent proxy: thin clients over ONE connection.

Reference parity: python/ray/util/client/ (`ray.init("ray://…")` — a
gRPC proxy server re-executes the API in-cluster and owns the objects;
the client holds opaque ids). Ours rides the existing frame protocol:

- `ClientProxyServer` runs inside the head driver/cluster process. Per
  client session it executes API calls against the real in-cluster
  client and PINS the resulting ObjectRefs in a session table, so thin
  clients never need cluster-routable addresses (the proxy is the
  owner-facing peer for everything).
- `ProxyModeClient` implements the same client surface as
  CoreClient/LocalModeClient (submit_task/create_actor/actor calls/
  get/put/wait/kill/kv/controller_rpc) by forwarding each call; the
  public API and libraries work unchanged. Select it with
  `ray_tpu_torch.init(address="client://host:port")`.

Sessions expire after `SESSION_TTL_S` of inactivity (a crashed thin
client must not pin objects forever); each RPC refreshes the TTL.
Streaming generators are not proxied (reference client has the same
late-arrival; use a driver attach for `num_returns="streaming"`).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .object_ref import ObjectRef
from .protocol import RpcClient, RpcServer
from .serialization import SerializedObject, serialize, serialize_code

SESSION_TTL_S = 600.0


def _walk_replace(obj, mapper, depth: int = 0):
    """Shallow-structure walk (tuple/list/dict, two levels like the
    worker-side arg resolution) replacing ObjectRefs via mapper."""
    if isinstance(obj, ObjectRef):
        return mapper(obj)
    if depth >= 2:
        return obj
    if isinstance(obj, tuple):
        return tuple(_walk_replace(x, mapper, depth + 1) for x in obj)
    if isinstance(obj, list):
        return [_walk_replace(x, mapper, depth + 1) for x in obj]
    if isinstance(obj, dict):
        return {k: _walk_replace(v, mapper, depth + 1)
                for k, v in obj.items()}
    return obj


class _Session:
    def __init__(self, namespace: str):
        self.namespace = namespace
        self.refs: Dict[str, ObjectRef] = {}   # pinned for the client
        self.last_seen = time.monotonic()


class ClientProxyServer:
    """In-cluster side. Runs on its OWN event loop; blocking calls into
    the inner client go through a thread pool (the inner client's sync
    surface bounces work onto the driver loop via run_coroutine_
    threadsafe, which requires calling from a non-driver-loop thread —
    and one client's long-blocking get must not freeze other clients).
    """

    def __init__(self, inner_client, host: str = None, port: int = 10001):
        import concurrent.futures

        from .core import LoopRunner
        self.inner = inner_client
        self.host = host
        self.port = port
        self.server = RpcServer()
        self.server.register_object(self)    # rpc_client_* -> client_*
        self.sessions: Dict[str, _Session] = {}
        self.address: Optional[Tuple[str, int]] = None
        self.loop_runner = LoopRunner()      # dedicated thread + loop
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="client-proxy")
        # content-addressed fn blobs: thin clients send each unique
        # function once (the in-cluster function store dedupes onward)
        self._fn_blobs: Dict[str, bytes] = {}

    def start(self) -> Tuple[str, int]:
        self.address = self.loop_runner.run_sync(
            self.server.start(self.host, self.port), timeout=10)
        return self.address

    def stop(self) -> None:
        try:
            self.loop_runner.run_sync(self.server.stop(), timeout=5)
        except Exception:
            pass
        self._pool.shutdown(wait=False)
        self.loop_runner.stop()

    async def _blocking(self, fn, *args):
        import asyncio
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, fn, *args)

    # ------------------------------------------------------------ session

    def _session(self, session_id: str) -> _Session:
        s = self.sessions.get(session_id)
        if s is None:
            raise RuntimeError(f"unknown client session {session_id[:8]} "
                               "(expired after inactivity?)")
        s.last_seen = time.monotonic()
        self._sweep()
        return s

    def _sweep(self) -> None:
        now = time.monotonic()
        for sid, s in list(self.sessions.items()):
            if now - s.last_seen > SESSION_TTL_S:
                del self.sessions[sid]       # drops pins -> normal GC

    async def rpc_client_hello(self, namespace: str = "default") -> dict:
        sid = uuid.uuid4().hex
        self.sessions[sid] = _Session(namespace)
        return {"session_id": sid,
                "namespace": namespace}

    async def rpc_client_bye(self, session_id: str) -> None:
        self.sessions.pop(session_id, None)

    async def rpc_client_touch(self, session_id: str) -> bool:
        """Keepalive: thin clients ping every ~60s so local compute or
        one long blocking get cannot TTL-expire the session."""
        s = self.sessions.get(session_id)
        if s is None:
            return False
        s.last_seen = time.monotonic()
        return True

    # ------------------------------------------------------------ helpers

    def _pin(self, session: _Session, ref: ObjectRef) -> str:
        session.refs[ref.id] = ref
        return ref.id

    def _real(self, session: _Session, obj):
        """Swap client-side refs (deserialized with unknown owner) for
        the session's pinned real refs."""
        def mapper(r):
            pinned = session.refs.get(r.id)
            if pinned is None:
                raise KeyError(
                    f"client passed unknown/released ref {r.id[:12]}")
            return pinned
        return _walk_replace(obj, mapper)

    # ------------------------------------------------------------ objects

    async def rpc_client_put(self, session_id: str, blob: bytes) -> str:
        s = self._session(session_id)
        value = self._real(
            s, SerializedObject.from_flat(blob).deserialize())
        ref = await self._blocking(self.inner.put, value)
        return self._pin(s, ref)

    async def rpc_client_get(self, session_id: str, ref_ids: List[str],
                             timeout: Optional[float] = None) -> bytes:
        import asyncio
        s = self._session(session_id)
        refs = [s.refs[i] for i in ref_ids]

        async def gather():
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            return await asyncio.gather(
                *[self.inner.aio_get(r, deadline=deadline) for r in refs])

        try:
            # no executor thread held: a long get parks a coroutine on
            # the inner client's loop, so N waiting clients cost nothing
            values = await asyncio.wrap_future(
                asyncio.run_coroutine_threadsafe(
                    gather(), self.inner.loop_runner.loop))
        except Exception as e:
            # exception-type parity: ship the typed error for the thin
            # client to re-raise (the RPC layer would flatten it into a
            # RemoteCallError string otherwise)
            try:
                return serialize(("err", e)).to_flat()
            except Exception:
                raise e
        # nested refs inside returned values (e.g. a task returning
        # [ray_tpu_torch.put(x)]) must be pinned or the client cannot use them
        s.last_seen = time.monotonic()     # long get ≠ idle session
        _walk_replace(values, lambda r: (self._pin(s, r), r)[1])
        return serialize(("ok", values)).to_flat()

    async def rpc_client_wait(self, session_id: str, ref_ids: List[str],
                              num_returns: int,
                              timeout: Optional[float]) -> dict:
        s = self._session(session_id)
        refs = [s.refs[i] for i in ref_ids]
        ready, pending = await self._blocking(
            lambda: self.inner.wait(refs, num_returns=num_returns,
                                    timeout=timeout))
        return {"ready": [r.id for r in ready],
                "pending": [r.id for r in pending]}

    async def rpc_client_release(self, session_id: str,
                                 ref_ids: List[str]) -> None:
        s = self.sessions.get(session_id)
        if s is None:
            return
        s.last_seen = time.monotonic()
        for i in ref_ids:
            s.refs.pop(i, None)

    # ------------------------------------------------------------- tasks

    async def rpc_client_task(self, session_id: str, fn_blob: bytes,
                              args_blob: bytes, opts: dict,
                              fn_hash: Optional[str] = None):
        s = self._session(session_id)
        from .serialization import deserialize_code
        if fn_blob is None:
            fn_blob = self._fn_blobs.get(fn_hash)
            if fn_blob is None:
                return {"need_blob": True}
        elif fn_hash is not None:
            self._fn_blobs[fn_hash] = fn_blob
        fn = deserialize_code(fn_blob)
        args, kwargs = SerializedObject.from_flat(args_blob).deserialize()
        args = self._real(s, tuple(args))
        kwargs = self._real(s, kwargs)
        if opts.get("num_returns") == "streaming":
            raise NotImplementedError(
                "streaming generators are not proxied; attach a driver")
        out = await self._blocking(
            lambda: self.inner.submit_task(fn, args, kwargs, opts,
                                           fn_blob=fn_blob,
                                           fn_hash=fn_hash))
        refs = out if isinstance(out, list) else [out]
        return {"refs": [self._pin(s, r) for r in refs]}

    async def rpc_client_create_actor(self, session_id: str,
                                      cls_blob: bytes, args_blob: bytes,
                                      opts: dict) -> dict:
        s = self._session(session_id)
        from .serialization import deserialize_code
        cls = deserialize_code(cls_blob)
        args, kwargs = SerializedObject.from_flat(args_blob).deserialize()
        args = self._real(s, tuple(args))
        kwargs = self._real(s, kwargs)
        opts = dict(opts)
        opts.setdefault("namespace", s.namespace)
        actor_id, creation_ref = await self._blocking(
            lambda: self.inner.create_actor(cls, args, kwargs, opts,
                                            cls_blob=cls_blob))
        return {"actor_id": actor_id,
                "creation_ref": self._pin(s, creation_ref)}

    async def rpc_client_actor_call(self, session_id: str, actor_id: str,
                                    method_name: str, args_blob: bytes,
                                    opts: dict) -> str:
        s = self._session(session_id)
        args, kwargs = SerializedObject.from_flat(args_blob).deserialize()
        args = self._real(s, tuple(args))
        kwargs = self._real(s, kwargs)
        if opts.get("num_returns") == "streaming":
            raise NotImplementedError(
                "streaming generators are not proxied; attach a driver")
        ref = await self._blocking(
            lambda: self.inner.submit_actor_task(actor_id, method_name,
                                                 args, kwargs, opts))
        return self._pin(s, ref)

    async def rpc_client_kill(self, session_id: str, actor_id: str,
                              no_restart: bool = True) -> None:
        self._session(session_id)
        await self._blocking(
            lambda: self.inner.kill_actor(actor_id, no_restart=no_restart))

    async def rpc_client_get_actor(self, session_id: str, name: str,
                                   namespace: Optional[str]) -> Optional[dict]:
        s = self._session(session_id)
        return await self._blocking(
            lambda: self.inner.get_actor_handle_info(
                name, namespace or s.namespace))

    # ------------------------------------------------------------ cluster

    async def rpc_client_rpc(self, session_id: str, method: str,
                             kwargs: dict):
        """Controller passthrough (nodes/resources/kv/state API)."""
        self._session(session_id)
        return await self._blocking(
            lambda: self.inner.controller_rpc(method, **kwargs))


# ======================================================== thin client


class _ProxyRefCounter:
    """Local counts only; zero -> release RPC to the proxy."""

    def __init__(self, client: "ProxyModeClient"):
        self._client = client
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add_local_ref(self, ref_id, owner_addr=None, borrowed=False):
        with self._lock:
            self._counts[ref_id] = self._counts.get(ref_id, 0) + 1

    def remove_local_ref(self, ref_id):
        with self._lock:
            n = self._counts.get(ref_id, 0) - 1
            if n > 0:
                self._counts[ref_id] = n
                return
            self._counts.pop(ref_id, None)
        self._client._release(ref_id)

    def register_owned(self, *a, **k):
        pass

    def pin(self, *a, **k):
        pass

    def unpin(self, *a, **k):
        pass


class ProxyModeClient:
    """The surface of CoreClient/LocalModeClient, forwarded over one
    connection to a ClientProxyServer."""

    is_local_mode = False
    is_proxy_mode = True

    def __init__(self, host: str, port: int, namespace: str = "default"):
        from .core import LoopRunner
        self.namespace = namespace
        self.loop_runner = LoopRunner()      # owns a background thread
        self._rpc = RpcClient(host, port)
        self.ref_counter = _ProxyRefCounter(self)
        self.is_shutdown = False
        self._sent_fn_hashes = set()
        hello = self._call("client_hello", _rpc_timeout=30,
                           namespace=namespace)
        self.session_id = hello["session_id"]
        self._start_keepalive()

    # ------------------------------------------------------------- plumbing

    def _call(self, _method: str, _rpc_timeout: Optional[float] = None,
              **kwargs):
        # unbounded by default: get(timeout=None) must block like a
        # driver attach, not fail at an arbitrary RPC ceiling
        return self.loop_runner.run_sync(
            self._rpc.call(_method, **kwargs), timeout=_rpc_timeout)

    def _scall(self, _method: str, _rpc_timeout: Optional[float] = None,
               **kwargs):
        return self._call(_method, _rpc_timeout=_rpc_timeout,
                          session_id=self.session_id, **kwargs)

    def _start_keepalive(self) -> None:
        import asyncio

        async def beat():
            while not self.is_shutdown:
                await asyncio.sleep(60.0)
                try:
                    await self._rpc.call("client_touch",
                                         session_id=self.session_id)
                except Exception:
                    pass

        self.loop_runner.call_soon(beat())

    def _release(self, ref_id: str) -> None:
        if self.is_shutdown:
            return
        try:
            self.loop_runner.call_soon(self._rpc.oneway(
                "client_release", session_id=self.session_id,
                ref_ids=[ref_id]))
        except Exception:
            pass

    def _ref(self, ref_id: str) -> ObjectRef:
        return ObjectRef(ref_id, None, _client=self)

    @staticmethod
    def _args_blob(args, kwargs) -> bytes:
        return serialize((tuple(args), dict(kwargs))).to_flat()

    # ------------------------------------------------------------- objects

    def put(self, value: Any) -> ObjectRef:
        return self._ref(self._scall(
            "client_put", blob=serialize(value).to_flat()))

    @staticmethod
    def _decode_get(blob: bytes):
        tag, payload = SerializedObject.from_flat(blob).deserialize()
        if tag == "err":
            raise payload            # typed server-side error (TaskError…)
        return payload

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        blob = self._scall("client_get",
                           ref_ids=[r.id for r in ref_list],
                           timeout=timeout)
        values = self._decode_get(blob)
        return values[0] if single else values

    async def _get_on_own_loop(self, ref_ids, timeout):
        # runs ON loop_runner's loop — the RpcClient connection is bound
        # there and must not be driven from a foreign loop
        blob = await self._rpc.call(
            "client_get", session_id=self.session_id, ref_ids=ref_ids,
            timeout=timeout)
        return self._decode_get(blob)

    def as_future(self, ref: ObjectRef):
        import asyncio
        return asyncio.run_coroutine_threadsafe(
            self._get_on_own_loop([ref.id], None), self.loop_runner.loop)

    async def aio_get(self, ref: ObjectRef, deadline=None):
        import asyncio
        values = await asyncio.wrap_future(self.as_future(ref))
        return values[0]

    def wait(self, refs, num_returns: int = 1, timeout=None):
        ref_list = list(refs)
        by_id = {r.id: r for r in ref_list}
        reply = self._scall("client_wait",
                            ref_ids=[r.id for r in ref_list],
                            num_returns=num_returns, timeout=timeout)
        return ([by_id[i] for i in reply["ready"]],
                [by_id[i] for i in reply["pending"]])

    # ------------------------------------------------------------- tasks

    def submit_task(self, fn, args, kwargs, opts, fn_blob=None,
                    fn_hash=None):
        blob = fn_blob if fn_blob is not None else serialize_code(fn)
        if fn_hash is None:
            import hashlib
            fn_hash = hashlib.sha1(blob).hexdigest()
        args_blob = self._args_blob(args, kwargs)
        # send each unique function's blob once; afterwards only the
        # hash crosses the wire (server replies need_blob if it lost it)
        send_blob = fn_hash not in self._sent_fn_hashes
        reply = self._scall("client_task",
                            fn_blob=blob if send_blob else None,
                            fn_hash=fn_hash, args_blob=args_blob,
                            opts=_plain_opts(opts))
        if isinstance(reply, dict) and reply.get("need_blob"):
            reply = self._scall("client_task", fn_blob=blob,
                                fn_hash=fn_hash, args_blob=args_blob,
                                opts=_plain_opts(opts))
        self._sent_fn_hashes.add(fn_hash)
        refs = [self._ref(i) for i in reply["refs"]]
        return refs[0] if len(refs) == 1 else refs

    def create_actor(self, cls, args, kwargs, opts, cls_blob=None,
                     cls_hash=None):
        blob = cls_blob if cls_blob is not None else serialize_code(cls)
        reply = self._scall("client_create_actor", cls_blob=blob,
                            args_blob=self._args_blob(args, kwargs),
                            opts=_plain_opts(opts))
        return reply["actor_id"], self._ref(reply["creation_ref"])

    def submit_actor_task(self, actor_id, method, args, kwargs, opts):
        ref_id = self._scall("client_actor_call", actor_id=actor_id,
                             method_name=method,
                             args_blob=self._args_blob(args, kwargs),
                             opts=_plain_opts(opts))
        return self._ref(ref_id)

    def kill_actor(self, actor_id, no_restart=True):
        self._scall("client_kill", actor_id=actor_id,
                    no_restart=no_restart)

    def get_actor_handle_info(self, name, namespace=None):
        return self._scall("client_get_actor", name=name,
                           namespace=namespace)

    # ------------------------------------------------------------- cluster

    def controller_rpc(self, method: str, **kwargs):
        return self._scall("client_rpc", method=method, kwargs=kwargs)

    def cluster_resources(self):
        return self.controller_rpc("cluster_resources")

    def available_resources(self):
        return self.controller_rpc("available_resources")

    def nodes(self):
        return self.controller_rpc("list_nodes")

    def kv_put(self, key, value, overwrite=True):
        return self.controller_rpc("kv_put", key=key, value=value,
                                   overwrite=overwrite)

    def kv_get(self, key):
        return self.controller_rpc("kv_get", key=key)

    def kv_del(self, key):
        return self.controller_rpc("kv_del", key=key)

    def kv_keys(self, prefix=""):
        return self.controller_rpc("kv_keys", prefix=prefix)

    # ------------------------------------------------------------- lifecycle

    def shutdown(self):
        if getattr(self, "_closed", False):
            return
        self._closed = True
        self.is_shutdown = True
        try:
            self.loop_runner.run_sync(self._rpc.oneway(
                "client_bye", session_id=self.session_id), timeout=5)
        except Exception:
            pass
        try:
            self.loop_runner.run_sync(self._rpc.close(), timeout=5)
        except Exception:
            pass
        self.loop_runner.stop()


def _plain_opts(opts: dict) -> dict:
    """Options must cross the wire as plain data (scheduling strategies
    normalized to dicts by the callers already)."""
    return {k: v for k, v in (opts or {}).items() if v is not None}
