"""Serving pieces the generation engine rides: admission control, shape
bucketing, serving.* metrics, and the fleet tier above GenerationEngine —
FleetRouter over N replicas (in process, in a subprocess, or over TCP),
live migration, the page service, prefill/decode handoff and the
FleetSupervisor."""
from .admission import (AdmissionQueue, DeadlineExceededError,
                        ReplicaTimeoutError, Request, RequestTooLargeError,
                        ServerBusyError, ServingError)
from .bucketing import ShapeBucketer, SignatureCache
from .control import FleetSupervisor, SupervisorConfig
from .fleet import (CircuitBreaker, FleetConfig, FleetMetrics, FleetRouter,
                    ReplicaSpec)
from .metrics import ServingMetrics

__all__ = ["AdmissionQueue", "DeadlineExceededError", "Request",
           "RequestTooLargeError", "ServerBusyError", "ServingError",
           "ReplicaTimeoutError", "ShapeBucketer", "SignatureCache",
           "ServingMetrics", "FleetRouter", "FleetConfig", "FleetMetrics",
           "ReplicaSpec", "CircuitBreaker", "FleetSupervisor",
           "SupervisorConfig"]
