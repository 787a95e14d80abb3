"""Driver-side bootstrap: ray_tpu_torch.init()/shutdown() and the head node.

Reference parity: python/ray/_private/worker.py (ray.init :1285, connect
:2279, shutdown :1901) + node.py — collapsed: the controller and the head
node daemon run inside the driver process's background event loop (worker
processes are real subprocesses), so bring-up is milliseconds and teardown
is deterministic. Additional daemons (real or fake multi-node) register
with the same controller over TCP.
"""

from __future__ import annotations

import atexit
import os
import time
from typing import Dict, List, Optional

from .controller import Controller
from .core import CoreClient, LoopRunner
from .daemon import NodeDaemon
from . import state

_runtime = None


class Runtime:
    """Everything owned by this driver's session."""

    def __init__(self, client: CoreClient, controller: Controller,
                 head_daemon: Optional[NodeDaemon], loop_runner: LoopRunner,
                 session_name: str):
        self.client = client
        self.controller = controller
        self.head_daemon = head_daemon
        self.loop_runner = loop_runner
        self.session_name = session_name
        self.extra_daemons: List[NodeDaemon] = []
        self.usage_reporter = None   # UsageReporter when stats enabled


def init(address: Optional[str] = None,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         labels: Optional[Dict[str, str]] = None,
         namespace: str = "default",
         ignore_reinit_error: bool = False,
         local_mode: bool = False,
         log_to_driver: Optional[bool] = None,
         _prestart_workers: int = 0,
         **_ignored) -> "Runtime":
    global _runtime
    if "num_tpus" in _ignored:
        raise ValueError("ray_tpu_torch schedules GPUs: pass num_gpus, "
                         "not num_tpus")
    if _runtime is not None:
        if ignore_reinit_error:
            return _runtime
        raise RuntimeError("ray_tpu_torch.init() called twice; "
                           "pass ignore_reinit_error=True to allow.")
    if local_mode:
        from .local_mode import LocalModeClient
        client = LocalModeClient(namespace=namespace)
        state.set_client(client)
        _runtime = Runtime(client, None, None, None, "local")
        atexit.register(shutdown)
        return _runtime

    if address is not None and address.startswith("client://"):
        # thin-client attach over ONE connection through the client
        # proxy (reference parity: ray.init("ray://…") client mode);
        # no cluster-routable addresses needed on this side.
        from .client_proxy import ProxyModeClient
        hostport = address[len("client://"):]
        host, _, port = hostport.rpartition(":")
        client = ProxyModeClient(host or "127.0.0.1", int(port),
                                 namespace=namespace)
        state.set_client(client)
        _runtime = Runtime(client, None, None, client.loop_runner,
                           f"client-{client.session_id[:8]}")
        atexit.register(shutdown)
        return _runtime

    if address is not None:
        # attach to an existing cluster: address = "host:port" of the
        # controller (written to the cluster-address file by `ray_tpu_torch
        # start --head`). The reference's client scheme "ray://host:port"
        # is accepted as an alias.
        if address.startswith("ray://"):
            address = address[len("ray://"):]
        host, _, port = address.rpartition(":")
        controller_addr = (host or "127.0.0.1", int(port))
        loop_runner = LoopRunner()

        async def _fetch_info():
            from .protocol import RpcClient
            rpc = RpcClient(*controller_addr)
            try:
                return await rpc.call("get_session_info")
            finally:
                await rpc.close()

        info = loop_runner.run_sync(_fetch_info(), timeout=15)
        daemon_addr = info.get("head_daemon_addr")
        client = CoreClient(controller_addr,
                            tuple(daemon_addr) if daemon_addr else None,
                            info["session_name"], loop_runner=loop_runner,
                            namespace=namespace)
        client.start()
        state.set_client(client)
        # Attached drivers share the cluster's single log topic with the
        # head driver, so log streaming is opt-in for them (the head
        # driver gets it by default).
        if log_to_driver:
            _attach_log_stream(client)
        _runtime = Runtime(client, None, None, loop_runner,
                           info["session_name"])
        atexit.register(shutdown)
        return _runtime

    # urandom suffix: back-to-back init/shutdown/init in one process and
    # second would otherwise reuse the session dir (and now its persisted
    # gcs.db, resurrecting the previous session's actor table).
    session_name = f"s{int(time.time())}_{os.getpid()}_{os.urandom(2).hex()}"
    loop_runner = LoopRunner()

    node_resources = dict(resources or {})
    if num_cpus is not None:
        node_resources["CPU"] = float(num_cpus)
    elif "CPU" not in node_resources:
        node_resources["CPU"] = float(os.cpu_count() or 1)
    if num_gpus is not None:
        node_resources["GPU"] = float(num_gpus)
    else:
        from ..accelerators.gpu import GPUAcceleratorManager
        detected = GPUAcceleratorManager.autodetect_resources()
        for k, v in detected.items():
            node_resources.setdefault(k, v)

    async def _bootstrap():
        # RAY_TPU_BIND_HOST=0.0.0.0 makes every server this session
        # starts (controller, daemons, driver + worker CoreClients)
        # reachable from other hosts — see protocol.RpcServer.start.
        controller = Controller(session_name)
        await controller.start()
        daemon = NodeDaemon(controller.address, session_name,
                            resources=node_resources, labels=labels)
        await daemon.start()
        return controller, daemon

    controller, head_daemon = loop_runner.run_sync(_bootstrap(), timeout=30)
    client = CoreClient(controller.address,
                        head_daemon.address if head_daemon else None,
                        session_name, loop_runner=loop_runner,
                        namespace=namespace)
    client.start()
    state.set_client(client)
    if log_to_driver is None or log_to_driver:
        _attach_log_stream(client)
    _runtime = Runtime(client, controller, head_daemon, loop_runner,
                       session_name)
    from . import usage as _usage
    if _usage.usage_stats_enabled():
        _runtime.usage_reporter = _usage.UsageReporter(client, session_name)
        _runtime.usage_reporter.start()
    if _prestart_workers:
        loop_runner.run_sync(
            client.pool.get(head_daemon.address).call(
                "prestart_workers", count=_prestart_workers), timeout=120)
    atexit.register(shutdown)
    return _runtime




def _attach_log_stream(client) -> None:
    """Print worker log lines on the driver (reference parity:
    log_monitor + worker_process_out streaming to the driver)."""
    import sys

    def _print(message):
        try:
            pid = message.get("pid")
            for line in message.get("data", "").splitlines():
                sys.stderr.write(f"(worker pid={pid}) {line}\n")
            sys.stderr.flush()
        except Exception:
            pass

    client.subscribe("__worker_logs__", _print)

def shutdown() -> None:
    global _runtime
    if _runtime is None:
        return
    rt, _runtime = _runtime, None
    state.set_client(None)
    if rt.usage_reporter is not None:
        rt.usage_reporter.stop()           # join first: no tmp-file race
        rt.usage_reporter.report_once()    # final snapshot
    if rt.loop_runner is None:   # local mode
        return
    rt.client.is_shutdown = True

    async def _teardown():
        for d in rt.extra_daemons:
            try:
                await d.stop()
            except Exception:
                pass
        if rt.head_daemon is not None:
            await rt.head_daemon.stop()
        if rt.controller is not None:
            await rt.controller.stop()

    for proxy in getattr(rt, "client_proxies", []):
        try:
            proxy.stop()
        except Exception:
            pass
    try:
        rt.loop_runner.run_sync(_teardown(), timeout=10)
    except Exception:
        pass
    try:
        rt.client.shutdown()
    except Exception:
        pass
    # session-wide arena teardown — only when this process OWNS the
    # session (attached drivers must not yank the arena from a live head)
    if rt.controller is not None:
        try:
            from .object_store import unlink_session_arena
            unlink_session_arena(rt.client.session_name)
        except Exception:
            pass
    rt.loop_runner.stop()
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass


def current_runtime() -> Optional[Runtime]:
    return _runtime


def start_client_proxy(port: int = 10001, host: Optional[str] = None):
    """Start the Ray-Client-equivalent proxy on this driver/head
    (reference parity: the ray:// client server). Thin clients attach
    with init(address="client://host:port"). Returns (host, port)."""
    rt = _runtime
    if rt is None or rt.loop_runner is None:
        raise RuntimeError("init() a non-local session first")
    from .client_proxy import ClientProxyServer
    server = ClientProxyServer(rt.client, host=host, port=port)
    addr = server.start()
    rt.client_proxies = getattr(rt, "client_proxies", [])
    rt.client_proxies.append(server)
    return addr


def add_fake_node(num_cpus: float = 1.0,
                  resources: Optional[Dict[str, float]] = None,
                  labels: Optional[Dict[str, str]] = None) -> str:
    """Register an extra in-process node daemon (multi-node testing).

    Reference parity: python/ray/cluster_utils.py:135 (Cluster.add_node) —
    each fake node runs a real NodeDaemon with its own worker processes.
    """
    rt = _runtime
    if rt is None or rt.controller is None:
        raise RuntimeError("init() a non-local session first")
    node_resources = dict(resources or {})
    node_resources.setdefault("CPU", num_cpus)

    async def _add():
        daemon = NodeDaemon(rt.controller.address, rt.session_name,
                            resources=node_resources, labels=labels)
        await daemon.start()
        return daemon

    daemon = rt.loop_runner.run_sync(_add(), timeout=30)
    rt.extra_daemons.append(daemon)
    return daemon.node_id


def remove_node(node_id: str) -> bool:
    """Stop a fake node's daemon (kills its workers) — chaos testing."""
    rt = _runtime
    if rt is None:
        return False
    for d in list(rt.extra_daemons):
        if d.node_id == node_id:
            async def _stop():
                await d.stop()
                await rt.controller.rpc_unregister_node(node_id=node_id)
            rt.loop_runner.run_sync(_stop(), timeout=15)
            rt.extra_daemons.remove(d)
            return True
    return False
