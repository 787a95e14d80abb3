"""Shared Serve types: statuses, request context, deployment ids.

Reference parity: serve/_private/common.py (DeploymentID, ReplicaID,
RequestMetadata) and serve/schema.py status models.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"
PROXY_NAME = "SERVE_PROXY"
GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"


def deployment_key(app_name: str, deployment_name: str) -> str:
    return f"{app_name}#{deployment_name}"


class DeploymentStatus:
    UPDATING = "UPDATING"
    HEALTHY = "HEALTHY"
    UNHEALTHY = "UNHEALTHY"
    UPSCALING = "UPSCALING"
    DOWNSCALING = "DOWNSCALING"


class ApplicationStatus:
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    DEPLOY_FAILED = "DEPLOY_FAILED"
    DELETING = "DELETING"
    NOT_STARTED = "NOT_STARTED"


class ReplicaState:
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    STOPPING = "STOPPING"


@dataclasses.dataclass
class RequestMetadata:
    request_id: str = ""
    call_method: str = "__call__"
    multiplexed_model_id: str = ""
    http_method: str = ""
    route: str = ""


@dataclasses.dataclass
class ReplicaTarget:
    """What the router needs to reach one replica."""
    replica_id: str
    actor_handle: Any
    max_ongoing_requests: int = 8


@dataclasses.dataclass
class DeploymentTargets:
    version: int
    replicas: list

    def to_wire(self) -> Dict[str, Any]:
        return {"version": self.version,
                "replicas": [(r.replica_id, r.actor_handle,
                              r.max_ongoing_requests)
                             for r in self.replicas]}

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "DeploymentTargets":
        return DeploymentTargets(
            version=d["version"],
            replicas=[ReplicaTarget(rid, h, moq)
                      for rid, h, moq in d["replicas"]])
