"""Multi-daemon test cluster: real node-daemon PROCESSES as fake nodes.

Reference parity: python/ray/cluster_utils.py:135 (Cluster / add_node /
remove_node) — the workhorse of the reference's distributed test suite.
Unlike `ray_tpu_torch.add_fake_node` (an extra in-process daemon sharing the
driver's event loop), every node here is a separate OS process running
the CLI worker-join path (`python -m ray_tpu_torch start --address`), so scheduling,
gossip, object transfer, and failure handling all cross real process +
socket boundaries.

    NOTE: init(ignore_reinit_error=True) — when the process already
    holds a head runtime, head_cpus is ignored and that session is
    reused; start Cluster first for a head sized by head_cpus.

    cluster = Cluster(head_cpus=2)
    n1 = cluster.add_node(num_cpus=2)
    n2 = cluster.add_node(num_cpus=2, resources={"accel": 1})
    ... drive ray_tpu_torch tasks/actors ...
    cluster.remove_node(n1)        # SIGKILL: node-failure chaos
    cluster.shutdown()
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import ray_tpu_torch


class Cluster:
    def __init__(self, head_cpus: float = 2.0, **init_kwargs):
        self._rt = ray_tpu_torch.init(num_cpus=head_cpus,
                                ignore_reinit_error=True, **init_kwargs)
        if self._rt.controller is None or self._rt.head_daemon is None:
            raise RuntimeError(
                "Cluster needs a head-owning runtime; this process is "
                "attached to a remote cluster (init(address=...)) — "
                "run Cluster in the head process")
        host, port = self._rt.controller.address
        self.address = f"{host}:{port}"
        self.head_node_id = self._rt.head_daemon.node_id
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: Dict[str, str] = {}

    # ------------------------------------------------------------ nodes
    def _alive_node_ids(self) -> List[str]:
        from ._private import state as _state
        return [n["node_id"] for n in
                _state.current_client().controller_rpc("list_nodes")
                if n.get("alive")]

    def add_node(self, num_cpus: float = 1.0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 timeout: float = 60.0) -> str:
        """Spawn a daemon process joined to this cluster; returns its
        node_id once the controller sees it alive."""
        before = set(self._alive_node_ids())
        cmd = [sys.executable, "-m", "ray_tpu_torch", "start",
               "--address", self.address, "--num-cpus", str(num_cpus)]
        if resources:
            cmd += ["--resources", json.dumps(resources)]
        if labels:
            cmd += ["--labels", json.dumps(labels)]
        penv = dict(os.environ)
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        penv["PYTHONPATH"] = os.pathsep.join(
            [pkg_parent] + [p for p in
                            penv.get("PYTHONPATH", "").split(os.pathsep)
                            if p])
        penv.update(env or {})
        log_path = os.path.join(
            self._rt.head_daemon.temp_dir, "logs",
            f"cluster-node-{len(self._procs)}.log")
        log_file = open(log_path, "ab")
        proc = subprocess.Popen(cmd, stdout=log_file,
                                stderr=subprocess.STDOUT, env=penv,
                                start_new_session=True)
        log_file.close()
        deadline = time.time() + timeout
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"cluster node process exited rc={proc.returncode}; "
                    f"see {log_path}")
            new = set(self._alive_node_ids()) - before
            if new:
                node_id = new.pop()
                self._procs[node_id] = proc
                self._logs[node_id] = log_path
                return node_id
            time.sleep(0.1)
        proc.kill()
        raise TimeoutError(
            f"node did not join within {timeout}s; see {log_path}")

    def remove_node(self, node_id: str, graceful: bool = False,
                    timeout: float = 30.0) -> None:
        """Kill a node's daemon process. graceful=False (default) is the
        chaos path: SIGKILL the whole process group, exactly like a node
        crash — the controller must detect it via health probes."""
        proc = self._procs.pop(node_id, None)
        if proc is None:
            return     # already removed (idempotent)
        sig = signal.SIGTERM if graceful else signal.SIGKILL
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            pass
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=5)
        # wait until the controller notices (probe-before-declare-dead)
        deadline = time.time() + timeout
        while time.time() < deadline:
            if node_id not in self._alive_node_ids():
                return
            time.sleep(0.2)
        raise TimeoutError(
            f"controller still thinks {node_id[:8]} is alive "
            f"after {timeout}s")

    def wait_for_nodes(self, count: int, timeout: float = 60.0) -> None:
        """Block until `count` nodes (incl. head) are alive."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self._alive_node_ids()) >= count:
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"{count} nodes not alive within {timeout}s "
            f"(have {len(self._alive_node_ids())})")

    # ------------------------------------------------------------ teardown
    def shutdown(self) -> None:
        for node_id in list(self._procs):
            proc = self._procs.pop(node_id, None)
            if proc is None:
                continue
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        ray_tpu_torch.shutdown()

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
