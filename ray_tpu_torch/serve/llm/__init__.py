"""ray_tpu_torch.serve.llm: multi-replica LLM serving fleets.

The port's own copy of ``ray_tpu/serve/llm``'s fleet plane over this
package's ``LLMServerImpl`` replicas:

- `FleetManager` over replica clients (`LocalReplicaClient` for
  in-process servers, `HandleReplicaClient` for anything with
  ``.remote``), with the ACTIVE / DRAINING / STANDBY / UNHEALTHY life
  cycle;
- `FleetRouter` (prefix-affine consistent-hash ring with spill and
  scored fallback), `AdmissionController` (bounded queue, tenant
  fairness, SLO shedding, brownout) and `FleetAutoscaler`;
- the failure plane (`CircuitBreaker`, `StreamTranscript`, token-exact
  stream failover) and `ChaosReplicaClient` to drive it;
- the KV transport (RTKV frames; disaggregated prefill, drain
  migration, failover-by-restore, `FleetPrefixStore`);
- observability (`SLOBurnWatchdog`, ingress traces merged with the
  replicas', the traffic recorder and its capture codec) and the
  preemptible `BatchLane`.

- `FleetConfig` + `build_llm_fleet_app`: N `LLMServerImpl` replica
  deployments behind one `LLMFleetIngressImpl`, deployed through
  `serve.run` (deployment.py); the OpenAI app (`build_openai_app`,
  `build_llm_deployment`) is re-exported from ``ray_tpu_torch.llm``.

A fleet also runs without serve, driven through its methods
(`dispatch`, `dispatch_stream`, `refresh`, `autoscale_tick`,
`watchdog_tick`, `status`, `metrics_text`).
Metric family names, label sets, wire formats and decisions are the
JAX package's.
"""

from __future__ import annotations

from ...llm import (ByteTokenizer, EngineConfig,  # noqa: F401
                    InferenceEngine, LLMConfig, Request,
                    SamplingParams, build_llm_deployment,
                    build_openai_app, load_tokenizer)

from .admission import (AdmissionConfig, AdmissionController,  # noqa: F401
                        AdmissionRejected)
from .autoscaler import (AutoscaleConfig, FleetAutoscaler,  # noqa: F401
                         FleetMetrics)
from .batch import (BATCH_PRIORITY, INTERACTIVE_PRIORITY,  # noqa: F401
                    BatchJob, BatchLane, BatchLaneConfig)
from .chaos import (ChaosError, ChaosReplicaClient,  # noqa: F401
                    ChaosSchedule, FaultSpec, StreamSevered)
from .deployment import (FleetConfig, LLMFleetIngressImpl,  # noqa: F401
                         build_llm_fleet_app)
from .failover import (CircuitBreaker, HealthConfig,  # noqa: F401
                       StreamTranscript)
from .fleet import (FleetManager, HandleReplicaClient,  # noqa: F401
                    LocalReplicaClient)
from .kv_transport import (FleetPrefixStore,  # noqa: F401
                           TransportChecksumError, TransportConfig,
                           TransportError, decode_prefix,
                           decode_session, encode_prefix,
                           encode_session)
from .router import (FleetRouter, HashRing, ReplicaSnapshot,  # noqa: F401
                     RouterConfig, prefix_fingerprint)
from .tracemerge import (IngressTraceBuffer,  # noqa: F401
                         filter_trace, merge_fleet_traces,
                         merge_flight_recorders)
from .trafficlog import (CaptureChecksumError,  # noqa: F401
                         CaptureError, TrafficRecorder,
                         decode_capture, load_capture,
                         sampling_brief, traffic_metrics)
from .watchdog import SLOBurnWatchdog, WatchdogConfig  # noqa: F401

__all__ = [
    # fleet layer
    "FleetConfig", "build_llm_fleet_app", "LLMFleetIngressImpl",
    "FleetManager", "LocalReplicaClient", "HandleReplicaClient",
    "FleetRouter", "RouterConfig", "ReplicaSnapshot", "HashRing",
    "prefix_fingerprint",
    "AdmissionConfig", "AdmissionController", "AdmissionRejected",
    "AutoscaleConfig", "FleetAutoscaler", "FleetMetrics",
    # failure-handling plane
    "HealthConfig", "CircuitBreaker", "StreamTranscript",
    "ChaosSchedule", "ChaosReplicaClient", "ChaosError",
    "StreamSevered", "FaultSpec",
    # observability layer
    "WatchdogConfig", "SLOBurnWatchdog", "IngressTraceBuffer",
    "merge_fleet_traces", "merge_flight_recorders", "filter_trace",
    # fleet KV transport
    "TransportConfig", "TransportError", "TransportChecksumError",
    "FleetPrefixStore", "encode_session", "decode_session",
    "encode_prefix", "decode_prefix",
    # preemptible batch lane
    "BatchLaneConfig", "BatchLane", "BatchJob",
    "BATCH_PRIORITY", "INTERACTIVE_PRIORITY",
    # traffic capture
    "TrafficRecorder", "CaptureError", "CaptureChecksumError",
    "decode_capture", "load_capture", "sampling_brief",
    "traffic_metrics",
    # single-model surface (ray_tpu_torch.llm re-exports)
    "LLMConfig", "build_openai_app", "build_llm_deployment",
    "InferenceEngine", "EngineConfig", "SamplingParams",
    "Request", "ByteTokenizer", "load_tokenizer",
]
