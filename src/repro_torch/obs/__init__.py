"""Observability: span tracer, metrics registry, Perfetto export — the
port's copy of ``repro/obs/__init__.py``.

The same plan/request/layer units the
:class:`~repro_torch.serve.ledger.TrafficLedger` charges bytes to get
wall-clock spans here, so every kernel span carries both an accounted
``traffic_bytes`` and a measured duration (achieved GB/s per layer; on
the card also the layer's own device time, ``device_us``).

Idiom::

    from repro_torch.obs import Tracer, write_trace

    tracer = Tracer()                      # or Tracer(clock=vclock)
    server = ImageServer(..., tracer=tracer)
    with tracer.activate():                # ambient: per-layer spans
        loop.run_sync(...)
    write_trace("serve.trace.json", tracer, server.metrics)
"""

from .tracer import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    active_tracer,
    set_active,
    timed_call,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .export import chrome_trace, events_jsonl, write_trace

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "active_tracer",
    "set_active",
    "timed_call",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "chrome_trace",
    "events_jsonl",
    "write_trace",
]
