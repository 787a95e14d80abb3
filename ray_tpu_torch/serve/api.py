"""Serve public API: @deployment, bind graphs, run/shutdown/status.

Reference parity: serve/api.py + serve/deployment.py (Deployment.bind →
Application graph), build_app.py (graph → per-deployment specs), and
serve.run's deploy-and-wait semantics.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Union

import ray_tpu_torch

from .config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from .handle import DeploymentHandle, _HandlePlaceholder
from ._private.common import (ApplicationStatus, CONTROLLER_NAME,
                              GRPC_PROXY_NAME, PROXY_NAME)


class Application:
    """A bound deployment graph node (reference: serve Application)."""

    def __init__(self, deployment: "Deployment", args: tuple,
                 kwargs: dict):
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs


class Deployment:
    def __init__(self, func_or_class: Union[type, Callable], name: str,
                 config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                user_config: Any = None,
                autoscaling_config: Optional[
                    Union[AutoscalingConfig, Dict[str, Any]]] = None,
                health_check_period_s: Optional[float] = None,
                graceful_shutdown_timeout_s: Optional[float] = None,
                ray_actor_options: Optional[Dict[str, Any]] = None
                ) -> "Deployment":
        import copy
        cfg = copy.deepcopy(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if user_config is not None:
            cfg.user_config = user_config
        if autoscaling_config is not None:
            cfg.autoscaling_config = (
                autoscaling_config
                if isinstance(autoscaling_config, AutoscalingConfig)
                else AutoscalingConfig(**autoscaling_config))
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        if ray_actor_options is not None:
            cfg.ray_actor_options = _actor_options(ray_actor_options)
        return Deployment(self.func_or_class, name or self.name, cfg)


def _actor_options(opts: Dict[str, Any]) -> Dict[str, Any]:
    """Replica actor options, checked when the deployment is declared
    (``num_tpus`` and unknown options raise here, not in the
    controller's reconcile loop, which would retry them until
    ``serve.run`` timed out)."""
    from ..remote_function import validate_options
    return validate_options(dict(opts))


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: Optional[Union[int, str]] = None,
               max_ongoing_requests: int = 8,
               user_config: Any = None,
               autoscaling_config: Optional[
                   Union[AutoscalingConfig, Dict[str, Any]]] = None,
               health_check_period_s: float = 2.0,
               graceful_shutdown_timeout_s: float = 5.0,
               ray_actor_options: Optional[Dict[str, Any]] = None):
    """@serve.deployment decorator (bare or with options)."""

    def build(target) -> Deployment:
        cfg = DeploymentConfig(
            num_replicas=(num_replicas
                          if isinstance(num_replicas, int) else 1),
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=_actor_options(ray_actor_options or {}))
        auto = autoscaling_config
        if num_replicas == "auto" and auto is None:
            auto = AutoscalingConfig()
        if auto is not None:
            cfg.autoscaling_config = (
                auto if isinstance(auto, AutoscalingConfig)
                else AutoscalingConfig(**auto))
        return Deployment(target, name or target.__name__, cfg)

    if _func_or_class is not None:
        return build(_func_or_class)
    return build


# ---------------------------------------------------------------- app build

def map_deployments(root: Application,
                    fn: Callable[["Deployment"], "Deployment"]
                    ) -> Application:
    """Rebuild the bind graph with each node's Deployment mapped through
    `fn`. The single graph walker shared by schema overrides and
    runtime-env folding — handles Applications nested inside
    tuple/list/dict args exactly like _build_app_specs.sub()."""
    seen: Dict[int, Application] = {}

    def sub(obj):
        if isinstance(obj, Application):
            return visit(obj)
        if isinstance(obj, tuple):
            return tuple(sub(x) for x in obj)
        if isinstance(obj, list):
            return [sub(x) for x in obj]
        if isinstance(obj, dict):
            return {k: sub(v) for k, v in obj.items()}
        return obj

    def visit(node: Application) -> Application:
        if id(node) in seen:
            return seen[id(node)]
        new = Application(
            fn(node._deployment),
            tuple(sub(a) for a in node._args),
            {k: sub(v) for k, v in node._kwargs.items()})
        seen[id(node)] = new
        return new

    return visit(root)


def _build_app_specs(root: Application, app_name: str
                     ) -> (str, List[Dict[str, Any]]):
    """Walk the bind graph; one spec per unique Application node, nested
    nodes replaced by handle placeholders in the parent's init args."""
    from ._private.serialization_helpers import (serialize_args,
                                                 serialize_callable)

    names: Dict[int, str] = {}
    specs: List[Dict[str, Any]] = []
    used: Dict[str, int] = {}

    def assign_name(node: Application) -> str:
        if id(node) in names:
            return names[id(node)]
        base = node._deployment.name
        n = used.get(base, 0)
        used[base] = n + 1
        name = base if n == 0 else f"{base}_{n}"
        names[id(node)] = name
        return name

    def sub(obj):
        if isinstance(obj, Application):
            child = visit(obj)
            return _HandlePlaceholder(child, app_name)
        if isinstance(obj, tuple):
            return tuple(sub(x) for x in obj)
        if isinstance(obj, list):
            return [sub(x) for x in obj]
        if isinstance(obj, dict):
            return {k: sub(v) for k, v in obj.items()}
        return obj

    visited: Dict[int, str] = {}

    def visit(node: Application) -> str:
        if id(node) in visited:
            return visited[id(node)]
        name = assign_name(node)
        visited[id(node)] = name
        args = sub(node._args)
        kwargs = sub(node._kwargs)
        callable_blob = serialize_callable(node._deployment.func_or_class)
        init_args_blob = serialize_args(args, kwargs)
        cfg = node._deployment.config
        version = hashlib.sha1(
            callable_blob + init_args_blob
            + repr(cfg.user_config).encode()).hexdigest()[:16]
        specs.append({
            "name": name,
            "callable_blob": callable_blob,
            "init_args_blob": init_args_blob,
            "config": cfg,
            "version": version,
        })
        return name

    ingress = visit(root)
    return ingress, specs


# ---------------------------------------------------------------- lifecycle

def _get_controller(start: bool = True):
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        if not start:
            raise
    from ._private.controller import ServeController
    cls = ray_tpu_torch.remote(num_cpus=0)(ServeController)
    controller = cls.options(name=CONTROLLER_NAME, lifetime="detached",
                             max_concurrency=64).remote()
    ray_tpu_torch.get(controller.start_loop.remote(), timeout=60)
    return controller


def start(http_options: Optional[Union[HTTPOptions, Dict[str, Any]]] = None,
          **_compat) -> None:
    """Start Serve system actors (controller + HTTP proxy)."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    controller = _get_controller()
    if http_options is None:
        http_options = HTTPOptions()
    elif isinstance(http_options, dict):
        http_options = HTTPOptions(**http_options)
    try:
        ray_tpu_torch.get_actor(PROXY_NAME)
    except ValueError:
        from ._private.proxy import ProxyActor
        cls = ray_tpu_torch.remote(num_cpus=0)(ProxyActor)
        proxy = cls.options(name=PROXY_NAME, lifetime="detached",
                            max_concurrency=256).remote(
            http_options.host, http_options.port)
        ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    return controller


def start_grpc(host: str = "127.0.0.1", port: int = 9000) -> int:
    """Start the gRPC ingress proxy (reference parity: the reference's
    gRPCProxy runs beside the HTTP proxy). Returns the bound port.
    Service raytpu.serve.Serve: Predict (unary bytes) / PredictStream
    (server-streaming bytes), app selected by 'application' metadata."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    _get_controller()
    try:
        proxy = ray_tpu_torch.get_actor(GRPC_PROXY_NAME)
    except ValueError:
        from ._private.grpc_proxy import GrpcProxyActor
        cls = ray_tpu_torch.remote(num_cpus=0)(GrpcProxyActor)
        proxy = cls.options(name=GRPC_PROXY_NAME, lifetime="detached",
                            max_concurrency=256).remote(host, port)
    return ray_tpu_torch.get(proxy.ready.remote(), timeout=60)


def run(target: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        _start_http: bool = True,
        http_options: Optional[HTTPOptions] = None,
        timeout_s: float = 120.0,
        local_testing_mode: bool = False) -> DeploymentHandle:
    """Deploy an application and wait until it is RUNNING; returns the
    ingress handle.

    local_testing_mode=True runs every deployment in THIS process with
    no cluster, controller, or proxy (reference parity:
    serve/_private/local_testing_mode.py) — handle calls go straight to
    in-process replicas; constructors run eagerly so init errors raise
    here."""
    if not isinstance(target, Application):
        raise TypeError("serve.run expects a bound Application "
                        "(use MyDeployment.bind(...))")
    if local_testing_mode:
        from ._private import local_testing
        ingress, specs = _build_app_specs(target, name)
        local_testing.clear(name)
        local_testing.deploy_local(name, ingress, specs)
        return DeploymentHandle(ingress, name)
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    if _start_http:
        start(http_options)
    controller = _get_controller()
    ingress, specs = _build_app_specs(target, name)
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, route_prefix or f"/{name}", ingress, specs), timeout=60)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote(), timeout=30)
        app = st["applications"].get(name)
        if app and app["status"] == ApplicationStatus.RUNNING:
            break
        time.sleep(0.2)
    else:
        raise TimeoutError(
            f"application {name!r} not RUNNING after {timeout_s}s: "
            f"{ray_tpu_torch.get(controller.status.remote())}")
    handle = DeploymentHandle(ingress, name)
    if blocking:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return handle


def deploy_config(config: Union[str, Dict[str, Any], "Any"], *,
                  timeout_s: float = 120.0
                  ) -> Dict[str, DeploymentHandle]:
    """Declarative deploy (the `serve deploy app.yaml` path).

    `config` is a YAML file path, a dict, or a ServeDeploySchema. Each
    application's import_path is resolved, per-deployment overrides
    applied, and the app deployed through the normal controller
    reconcile; returns {app_name: ingress handle}. Reference parity:
    serve/scripts.py `serve deploy` + schema.py ServeDeploySchema."""
    from .schema import ServeDeploySchema, build_app_from_schema
    if isinstance(config, str):
        schema = ServeDeploySchema.from_yaml(config)
    elif isinstance(config, dict):
        schema = ServeDeploySchema.from_dict(config)
    else:
        schema = config
    http = (HTTPOptions(**schema.http_options)
            if schema.http_options else None)
    handles: Dict[str, DeploymentHandle] = {}
    for app in schema.applications:
        target = build_app_from_schema(app)
        if app.runtime_env:
            target = _fold_runtime_env(target, app.runtime_env)
        handles[app.name] = run(
            target, name=app.name, route_prefix=app.route_prefix,
            http_options=http, timeout_s=timeout_s)
    return handles


def _fold_runtime_env(root: Application, runtime_env: Dict[str, Any]
                      ) -> Application:
    """App-level runtime_env becomes the default for every deployment's
    replica actors (per-deployment ray_actor_options.runtime_env wins)."""
    def fold(dep: Deployment) -> Deployment:
        opts = dict(dep.config.ray_actor_options)
        if "runtime_env" in opts:
            return dep
        opts["runtime_env"] = dict(runtime_env)
        return dep.options(ray_actor_options=opts)

    return map_deployments(root, fold)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_controller(start=False)
    ingress = ray_tpu_torch.get(controller.get_app_ingress.remote(name),
                          timeout=30)
    if ingress is None:
        raise ValueError(f"no application named {name!r}")
    return DeploymentHandle(ingress, name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def status() -> Dict[str, Any]:
    controller = _get_controller(start=False)
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def delete(name: str, _blocking: bool = True) -> None:
    from ._private import local_testing
    if local_testing.has_app(name):
        local_testing.clear(name)
        return
    controller = _get_controller(start=False)
    ray_tpu_torch.get(controller.delete_application.remote(name), timeout=60)


def shutdown() -> None:
    from ._private import local_testing
    local_testing.clear()
    if not ray_tpu_torch.is_initialized():
        return
    try:
        controller = _get_controller(start=False)
    except ValueError:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
    except Exception:
        pass
    for actor_name in (PROXY_NAME, GRPC_PROXY_NAME, CONTROLLER_NAME):
        try:
            actor = ray_tpu_torch.get_actor(actor_name)
            if actor_name in (PROXY_NAME, GRPC_PROXY_NAME):
                try:
                    ray_tpu_torch.get(actor.shutdown.remote(), timeout=10)
                except Exception:
                    pass
            ray_tpu_torch.kill(actor)
        except Exception:
            pass
    from . import handle as _handle_mod
    with _handle_mod._routers_lock:
        _handle_mod._routers.clear()
