"""Batched image serving: bucketed admission, the per-request traffic
ledger and the server over the conv kernel, wrapped in a fault-tolerant
serving loop (deadline shedding, retry/backoff, circuit-breaker
degradation to account-only, seeded fault injection)."""

from repro_torch.serve.bucketing import (DEFAULT_BUCKETS, AdmissionQueue,
                                         ImageRequest, bucket_for)
from repro_torch.serve.faults import (FaultEvent, FaultPlan, InjectedFault,
                                      VirtualClock)
from repro_torch.serve.ledger import RequestCharge, TrafficLedger
from repro_torch.serve.loop import (CircuitBreaker, RequestState,
                                    ServingLoop, TrackedRequest)
from repro_torch.serve.server import ImageServer, ServeResult

__all__ = ["DEFAULT_BUCKETS", "AdmissionQueue", "ImageRequest",
           "bucket_for", "RequestCharge", "TrafficLedger",
           "ImageServer", "ServeResult", "ServingLoop", "RequestState",
           "TrackedRequest", "CircuitBreaker", "FaultPlan",
           "FaultEvent", "InjectedFault", "VirtualClock"]
