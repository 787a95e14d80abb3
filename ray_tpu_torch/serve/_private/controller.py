"""ServeController: reconciles desired app/deployment state to replicas.

Reference parity: serve/_private/controller.py:84 (control loop :369),
deployment_state.py (DeploymentStateManager.update :2663 — replica
start/stop/rolling update), autoscaling_state.py:262 (request-metric
autoscaling), long_poll.py:204 (change broadcast — here a versioned
long-poll on the replica-target snapshot).

Runs as a named async ray_tpu_torch actor; the reconcile loop is an asyncio
task on the actor's event loop. Blocking client APIs (kill) are pushed to
a thread so the loop never blocks.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch

from ..config import AutoscalingConfig, DeploymentConfig
from .common import (ApplicationStatus, DeploymentStatus, ReplicaState,
                     deployment_key)
from .replica import Replica

logger = logging.getLogger("ray_tpu_torch.serve")

RECONCILE_PERIOD_S = 0.25


class _ReplicaInfo:
    def __init__(self, replica_id: str, handle, version: str):
        self.replica_id = replica_id
        self.handle = handle
        self.version = version
        self.state = ReplicaState.STARTING
        self.last_health = time.time()
        self.ongoing = 0.0
        self.qps = 0.0
        self.total_requests = 0.0
        # optional health_detail() payload from the last metrics poll
        # (LLM replicas: queue depth, KV occupancy, last-tick age)
        self.detail: Optional[Dict] = None
        self.health_task: Optional[asyncio.Task] = None


def _retire_replica(info: "_DeploymentInfo", replica_id: str):
    """Remove a replica, folding its request count into the
    deployment's retired total (cumulative metrics must not drop when
    replicas churn)."""
    rep = info.replicas.pop(replica_id, None)
    if rep is not None:
        info.retired_requests += getattr(rep, "total_requests", 0.0)
    return rep


class _DeploymentInfo:
    def __init__(self, name: str, app: str, spec: Dict[str, Any]):
        self.name = name
        self.app = app
        self.key = deployment_key(app, name)
        self.replicas: Dict[str, _ReplicaInfo] = {}
        self.seq = 0
        self.targets_version = 0
        self.status = DeploymentStatus.UPDATING
        # autoscaling bookkeeping
        self.autoscale_target: Optional[int] = None
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        # consecutive replica-start failures → exponential respawn backoff
        self.start_failures = 0
        self.next_start_at = 0.0
        # requests served by replicas that have since been removed
        # (downscale/health-kill/update) — keeps the deployment's
        # total_requests metric genuinely cumulative
        self.retired_requests = 0.0
        self.apply_spec(spec)

    def apply_spec(self, spec: Dict[str, Any]) -> None:
        if spec["version"] != getattr(self, "version", None):
            # fresh code/config deserves a fresh backoff ladder
            self.start_failures = 0
            self.next_start_at = 0.0
        self.callable_blob = spec["callable_blob"]
        self.init_args_blob = spec["init_args_blob"]
        self.version = spec["version"]
        cfg = spec["config"]
        self.config: DeploymentConfig = (
            cfg if isinstance(cfg, DeploymentConfig)
            else DeploymentConfig(**cfg))
        if self.autoscale_target is None and self.config.autoscaling_config:
            self.autoscale_target = \
                self.config.autoscaling_config.min_replicas

    # -- target sizing ------------------------------------------------------
    def target_count(self) -> int:
        auto = self.config.autoscaling_config
        if auto is None:
            return self.config.num_replicas
        return self.autoscale_target or auto.min_replicas

    def autoscale_tick(self) -> None:
        auto = self.config.autoscaling_config
        if auto is None:
            return
        running = [r for r in self.replicas.values()
                   if r.state == ReplicaState.RUNNING]
        if not running:
            return
        total_ongoing = sum(r.ongoing for r in running)
        desired = auto.desired(total_ongoing, len(running))
        now = time.time()
        current = self.target_count()
        if desired > current:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since >= auto.upscale_delay_s:
                self.autoscale_target = desired
                self._above_since = None
        elif desired < current:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since >= auto.downscale_delay_s:
                self.autoscale_target = desired
                self._below_since = None
        else:
            self._above_since = self._below_since = None


class ServeController:
    def __init__(self):
        self._apps: Dict[str, Dict[str, Any]] = {}
        self._deployments: Dict[str, _DeploymentInfo] = {}
        self._loop_task: Optional[asyncio.Task] = None
        self._change_event: Optional[asyncio.Event] = None
        self._shutdown = False

    # -- lifecycle ----------------------------------------------------------
    async def start_loop(self) -> bool:
        if self._loop_task is None:
            self._change_event = asyncio.Event()
            self._loop_task = asyncio.create_task(self._reconcile_loop())
        return True

    async def _reconcile_loop(self) -> None:
        while not self._shutdown:
            try:
                await self._reconcile_once()
            except Exception:
                logger.exception("reconcile iteration failed")
            await asyncio.sleep(RECONCILE_PERIOD_S)

    # -- public control plane ----------------------------------------------
    async def deploy_application(self, app_name: str, route_prefix: str,
                                 ingress: str,
                                 deployments: List[Dict[str, Any]]) -> bool:
        app = self._apps.setdefault(
            app_name, {"route_prefix": route_prefix, "ingress": ingress,
                       "status": ApplicationStatus.DEPLOYING,
                       "deployment_names": []})
        app["route_prefix"] = route_prefix
        app["ingress"] = ingress
        app["status"] = ApplicationStatus.DEPLOYING
        new_names = []
        for spec in deployments:
            name = spec["name"]
            new_names.append(name)
            key = deployment_key(app_name, name)
            info = self._deployments.get(key)
            if info is None:
                self._deployments[key] = _DeploymentInfo(
                    name, app_name, spec)
            else:
                info.apply_spec(spec)
                info.status = DeploymentStatus.UPDATING
        # deployments removed from the app spec get torn down
        for old in app["deployment_names"]:
            if old not in new_names:
                key = deployment_key(app_name, old)
                info = self._deployments.get(key)
                if info is not None:
                    await self._drain_all(info)
                    del self._deployments[key]
        app["deployment_names"] = new_names
        return True

    async def delete_application(self, app_name: str) -> bool:
        app = self._apps.pop(app_name, None)
        if app is None:
            return False
        for name in app["deployment_names"]:
            key = deployment_key(app_name, name)
            info = self._deployments.pop(key, None)
            if info is not None:
                await self._drain_all(info)
        return True

    async def get_deployment_targets(self, key: str
                                     ) -> Optional[Dict[str, Any]]:
        info = self._deployments.get(key)
        if info is None:
            return None
        replicas = [(r.replica_id, r.handle, self._moq(info))
                    for r in info.replicas.values()
                    if r.state == ReplicaState.RUNNING]
        return {"version": info.targets_version, "replicas": replicas}

    @staticmethod
    def _moq(info: _DeploymentInfo) -> int:
        return info.config.max_ongoing_requests

    async def listen_for_change(self, key: str, known_version: int,
                                timeout_s: float = 10.0
                                ) -> Optional[Dict[str, Any]]:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            info = self._deployments.get(key)
            if info is not None and info.targets_version != known_version:
                return await self.get_deployment_targets(key)
            try:
                await asyncio.wait_for(self._change_event.wait(),
                                       timeout=0.5)
            except asyncio.TimeoutError:
                pass
        return await self.get_deployment_targets(key)

    async def get_route_table(self) -> Dict[str, Any]:
        return {app["route_prefix"]: (name, app["ingress"])
                for name, app in self._apps.items()
                if app["status"] != ApplicationStatus.DELETING}

    async def get_app_ingress(self, app_name: str) -> Optional[str]:
        app = self._apps.get(app_name)
        return app["ingress"] if app else None

    async def status(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"applications": {}}
        for app_name, app in self._apps.items():
            deps = {}
            for name in app["deployment_names"]:
                info = self._deployments.get(
                    deployment_key(app_name, name))
                if info is None:
                    continue
                running = [r for r in info.replicas.values()
                           if r.state == ReplicaState.RUNNING]
                deps[name] = {
                    "status": info.status,
                    "replica_states": {
                        rid: r.state for rid, r in info.replicas.items()},
                    "target": info.target_count(),
                    "version": info.version,
                    # request metrics aggregated from the controller's
                    # replica polls (powers serve gauges on /metrics)
                    "metrics": {
                        "ongoing": sum(r.ongoing for r in running),
                        "qps_10s": sum(r.qps for r in running),
                        # cumulative: live replicas (any state) plus
                        # everything retired replicas ever served
                        "total_requests": info.retired_requests + sum(
                            r.total_requests
                            for r in info.replicas.values()),
                    },
                    # per-replica health detail: replicas
                    # exposing health_detail() — LLM servers report
                    # queue depth / KV occupancy / last-tick age —
                    # show their routing inputs here, so operators
                    # read them from serve.status() instead of
                    # hitting each replica's /stats
                    "replica_details": {
                        rid: r.detail
                        for rid, r in info.replicas.items()
                        if r.detail is not None},
                }
            out["applications"][app_name] = {
                "status": app["status"],
                "route_prefix": app["route_prefix"],
                "deployments": deps,
            }
        return out

    async def shutdown(self) -> bool:
        self._shutdown = True
        for info in list(self._deployments.values()):
            await self._drain_all(info)
        self._deployments.clear()
        self._apps.clear()
        return True

    # -- reconciliation -----------------------------------------------------
    async def _reconcile_once(self) -> None:
        for info in list(self._deployments.values()):
            await self._reconcile_deployment(info)
        # roll app statuses up from their deployments
        for app_name, app in self._apps.items():
            infos = [self._deployments.get(deployment_key(app_name, n))
                     for n in app["deployment_names"]]
            infos = [i for i in infos if i is not None]
            if infos and all(i.status == DeploymentStatus.HEALTHY
                             for i in infos):
                app["status"] = ApplicationStatus.RUNNING
            elif app["status"] != ApplicationStatus.DELETING:
                app["status"] = ApplicationStatus.DEPLOYING

    async def _reconcile_deployment(self, info: _DeploymentInfo) -> None:
        target = info.target_count()
        cur_version = [r for r in info.replicas.values()
                       if r.version == info.version]
        old_version = [r for r in info.replicas.values()
                       if r.version != info.version]
        running_new = [r for r in cur_version
                       if r.state == ReplicaState.RUNNING]
        # 1) start missing current-version replicas (with exponential
        # backoff after consecutive startup failures — a crashlooping
        # constructor must not hot-spin the cluster)
        missing = target - len(cur_version)
        if missing > 0 and time.time() >= info.next_start_at:
            for _ in range(missing):
                self._start_replica(info)
        # 2) rolling update: once enough new replicas run, drain old ones
        if old_version and len(running_new) >= min(target,
                                                   len(cur_version)):
            for r in old_version:
                await self._stop_replica(info, r)
        # 3) downscale excess current-version replicas
        excess = len(cur_version) - target
        if excess > 0:
            victims = sorted(
                cur_version,
                key=lambda r: (r.state == ReplicaState.RUNNING, r.ongoing)
            )[:excess]
            for r in victims:
                await self._stop_replica(info, r)
        # 4) health checks + metrics
        await self._probe_replicas(info)
        # 5) autoscaling decision
        info.autoscale_tick()
        # 6) status rollup
        healthy = [r for r in info.replicas.values()
                   if r.state == ReplicaState.RUNNING
                   and r.version == info.version]
        if len(healthy) >= info.target_count() and not old_version:
            info.status = DeploymentStatus.HEALTHY

    def _start_replica(self, info: _DeploymentInfo) -> None:
        info.seq += 1
        rid = f"{info.key}#{info.seq}"
        opts = dict(info.config.ray_actor_options)
        opts.setdefault("num_cpus", 0)
        actor_cls = ray_tpu_torch.remote(**opts)(Replica) if opts else \
            ray_tpu_torch.remote(Replica)
        handle = actor_cls.options(
            max_concurrency=info.config.max_ongoing_requests).remote(
            info.key, rid, info.callable_blob, info.init_args_blob,
            info.config.user_config)
        rep = _ReplicaInfo(rid, handle, info.version)
        info.replicas[rid] = rep
        rep.health_task = asyncio.create_task(
            self._await_startup(info, rep))

    async def _await_startup(self, info: _DeploymentInfo,
                             rep: _ReplicaInfo) -> None:
        try:
            await asyncio.wait_for(
                self._as_coro(rep.handle.check_health.remote()),
                timeout=60.0)
        except Exception as e:
            logger.warning("replica %s failed to start: %r",
                           rep.replica_id, e)
            _retire_replica(info, rep.replica_id)
            await self._kill(rep.handle)
            info.status = DeploymentStatus.UNHEALTHY
            info.start_failures += 1
            info.next_start_at = time.time() + min(
                2.0 ** min(info.start_failures, 10) * 0.5, 30.0)
            return
        rep.state = ReplicaState.RUNNING
        rep.last_health = time.time()
        info.start_failures = 0
        info.next_start_at = 0.0
        self._bump(info)

    async def _stop_replica(self, info: _DeploymentInfo,
                            rep: _ReplicaInfo) -> None:
        if rep.state == ReplicaState.STOPPING:
            return
        rep.state = ReplicaState.STOPPING
        self._bump(info)

        async def _drain_and_kill():
            try:
                await asyncio.wait_for(
                    self._as_coro(rep.handle.prepare_for_shutdown.remote()),
                    timeout=info.config.graceful_shutdown_timeout_s)
            except Exception:
                pass
            await self._kill(rep.handle)
            _retire_replica(info, rep.replica_id)

        asyncio.create_task(_drain_and_kill())

    async def _drain_all(self, info: _DeploymentInfo) -> None:
        for r in list(info.replicas.values()):
            try:
                await self._kill(r.handle)
            except Exception:
                pass
        info.replicas.clear()
        self._bump(info)

    async def _probe_replicas(self, info: _DeploymentInfo) -> None:
        now = time.time()
        for rep in list(info.replicas.values()):
            if rep.state != ReplicaState.RUNNING:
                continue
            if now - rep.last_health < info.config.health_check_period_s:
                continue
            try:
                metrics = await asyncio.wait_for(
                    self._as_coro(rep.handle.metrics.remote()),
                    timeout=info.config.health_check_timeout_s)
                rep.ongoing = float(metrics.get("ongoing", 0))
                rep.qps = float(metrics.get("qps_10s", 0.0))
                rep.total_requests = float(metrics.get("total", 0))
                rep.detail = metrics.get("detail")
                rep.last_health = now
            except Exception as e:
                logger.warning("replica %s failed health check: %r",
                               rep.replica_id, e)
                _retire_replica(info, rep.replica_id)
                await self._kill(rep.handle)
                self._bump(info)

    # -- helpers ------------------------------------------------------------
    @staticmethod
    async def _as_coro(ref):
        return await ref

    async def _kill(self, handle) -> None:
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(
                None, lambda: ray_tpu_torch.kill(handle, no_restart=True))
        except Exception:
            pass

    def _bump(self, info: _DeploymentInfo) -> None:
        info.targets_version += 1
        if self._change_event is not None:
            self._change_event.set()
            self._change_event = asyncio.Event()
