"""Declarative Serve config: the YAML deploy surface.

Reference parity: python/ray/serve/schema.py (ServeDeploySchema /
ServeApplicationSchema / DeploymentSchema — pydantic there, plain
dataclasses here) consumed by `serve deploy config.yaml` and
`serve.run_config()`. An application is named by an import path to a
bound Application (module:attr or dotted), with per-deployment option
overrides applied on top of the code's own @deployment options
(reference: serve/_private/build_app.py override semantics).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

from .config import AutoscalingConfig


@dataclasses.dataclass
class DeploymentSchema:
    """Option overrides for one deployment (reference schema.py:281)."""

    name: str
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    user_config: Any = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    health_check_period_s: Optional[float] = None
    graceful_shutdown_timeout_s: Optional[float] = None
    ray_actor_options: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentSchema":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown deployment option(s) {sorted(unknown)} "
                f"(known: {sorted(known)})")
        if "name" not in d:
            raise ValueError("every deployment override needs a 'name'")
        return cls(**d)


@dataclasses.dataclass
class ServeApplicationSchema:
    """One application (reference schema.py:496)."""

    import_path: str
    name: str = "default"
    route_prefix: Optional[str] = "/"
    runtime_env: Dict[str, Any] = dataclasses.field(default_factory=dict)
    deployments: List[DeploymentSchema] = dataclasses.field(
        default_factory=list)
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeApplicationSchema":
        d = dict(d)
        if "import_path" not in d:
            raise ValueError("application config needs an 'import_path'")
        deps = [DeploymentSchema.from_dict(x)
                for x in d.pop("deployments", [])]
        known = {f.name for f in dataclasses.fields(cls)} - {"deployments"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown application field(s) {sorted(unknown)}")
        return cls(deployments=deps, **d)


@dataclasses.dataclass
class ServeDeploySchema:
    """The whole config file (reference schema.py:709)."""

    applications: List[ServeApplicationSchema]
    http_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    grpc_options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeDeploySchema":
        d = dict(d)
        apps = d.pop("applications", None)
        if apps is None:
            # single-application form: the file IS one application
            return cls(applications=[ServeApplicationSchema.from_dict(d)])
        names = [a.get("name", "default") for a in apps]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate application names in {names}")
        real_prefixes = [p for p in
                         (a.get("route_prefix", "/") for a in apps) if p]
        if len(real_prefixes) != len(set(real_prefixes)):
            raise ValueError(f"duplicate route_prefix in {real_prefixes}")
        unknown = set(d) - {"http_options", "grpc_options"}
        if unknown:
            raise ValueError(f"unknown top-level field(s) {sorted(unknown)}")
        return cls(
            applications=[ServeApplicationSchema.from_dict(a) for a in apps],
            http_options=d.get("http_options", {}),
            grpc_options=d.get("grpc_options", {}))

    @classmethod
    def from_yaml(cls, path: str) -> "ServeDeploySchema":
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f)
        if not isinstance(data, dict):
            raise ValueError(f"{path} is not a YAML mapping")
        return cls.from_dict(data)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def import_attr(import_path: str):
    """'pkg.mod:attr' (preferred) or 'pkg.mod.attr' -> the attribute."""
    if ":" in import_path:
        module_name, attr = import_path.split(":", 1)
    else:
        module_name, _, attr = import_path.rpartition(".")
        if not module_name:
            raise ValueError(
                f"import_path {import_path!r} must be 'module:attr' "
                f"or 'module.attr'")
    module = importlib.import_module(module_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def build_app_from_schema(schema: ServeApplicationSchema):
    """Import the target and apply the schema's deployment overrides.

    The target may be a bound Application or a builder function taking
    the schema's `args` dict (reference: build_app.py + `args` field).
    Returns the Application with per-deployment config overridden.
    """
    from .api import Application

    target = import_attr(schema.import_path)
    if callable(target) and not isinstance(target, Application):
        target = target(schema.args) if schema.args else target()
    if not isinstance(target, Application):
        raise TypeError(
            f"{schema.import_path!r} resolved to {type(target).__name__}, "
            f"expected a bound Application")
    overrides = {d.name: d for d in schema.deployments}
    if overrides:
        target = _apply_overrides(target, overrides)
    return target


def _apply_overrides(root, overrides: Dict[str, DeploymentSchema]):
    """Rebuild the bind graph with per-deployment schema overrides.

    Raises if an override names a deployment that is not in the graph —
    a silently ignored override (typo'd name) deploys with defaults
    (reference: serve build_app validates override names)."""
    from .api import map_deployments

    consumed: set = set()

    def apply(dep):
        ov = overrides.get(dep.name)
        if ov is None:
            return dep
        consumed.add(dep.name)
        opts = {
            "num_replicas": ov.num_replicas,
            "max_ongoing_requests": ov.max_ongoing_requests,
            "user_config": ov.user_config,
            "health_check_period_s": ov.health_check_period_s,
            "graceful_shutdown_timeout_s": ov.graceful_shutdown_timeout_s,
            "ray_actor_options": ov.ray_actor_options,
        }
        if ov.autoscaling_config is not None:
            opts["autoscaling_config"] = AutoscalingConfig(
                **ov.autoscaling_config)
        return dep.options(
            **{k: v for k, v in opts.items() if v is not None})

    result = map_deployments(root, apply)
    unused = set(overrides) - consumed
    if unused:
        raise ValueError(
            f"deployment override(s) {sorted(unused)} match no deployment "
            f"in the application graph")
    return result
