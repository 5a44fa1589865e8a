"""Batched image serving: bucketed admission, the per-request traffic
ledger and the server over the conv kernel."""

from repro_torch.serve.bucketing import (DEFAULT_BUCKETS, AdmissionQueue,
                                         ImageRequest, bucket_for)
from repro_torch.serve.ledger import RequestCharge, TrafficLedger
from repro_torch.serve.server import ImageServer, ServeResult

__all__ = ["DEFAULT_BUCKETS", "AdmissionQueue", "ImageRequest",
           "bucket_for", "RequestCharge", "TrafficLedger",
           "ImageServer", "ServeResult"]
