"""Serve configuration models.

Reference parity: python/ray/serve/config.py (AutoscalingConfig,
DeploymentConfig pydantic models) and HTTPOptions. Plain dataclasses here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class AutoscalingConfig:
    """Request-driven replica autoscaling (reference
    serve/_private/autoscaling_state.py:262 — replicas sized from ongoing
    request metrics)."""
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 1.0
    downscale_delay_s: float = 5.0
    metrics_interval_s: float = 0.5

    def desired(self, total_ongoing: float, current: int) -> int:
        import math
        want = math.ceil(total_ongoing / max(self.target_ongoing_requests,
                                             1e-9))
        return max(self.min_replicas, min(self.max_replicas, want))


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    user_config: Any = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: Dict[str, Any] = dataclasses.field(
        default_factory=dict)

    def initial_target(self) -> int:
        if self.autoscaling_config is not None:
            return self.autoscaling_config.min_replicas
        return self.num_replicas


@dataclasses.dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000


@dataclasses.dataclass
class gRPCOptions:
    """Placeholder for API parity (reference serves gRPC alongside HTTP);
    the port routes everything through handles/HTTP."""
    port: int = 9000
    grpc_servicer_functions: tuple = ()
