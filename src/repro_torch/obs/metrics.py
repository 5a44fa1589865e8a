"""Process-local metrics registry: counters, gauges, histograms.

The port's copy of ``repro/obs/metrics.py``.

The numeric siblings of the tracer's spans.  Where a span answers
"where did *this* request's time go", the registry answers "what is
the steady-state shape of the system": queue depth, per-bucket
in-flight and backlog, shed/retry/breaker counts, plan-cache hit
rate, per-layer bytes and seconds.

Deliberately minimal and dependency-free:

  * instruments are **get-or-create** by ``(name, labels)`` — calling
    ``registry.counter("serve_shed", reason="deadline")`` twice
    returns the same object, so hot paths may also cache the handle;
  * the registry is **process-local and instance-scoped** — servers
    construct their own (no module-global default), which keeps tests
    hermetic and lets two servers in one process not share state;
  * ``snapshot()`` renders everything to one plain dict and
    ``render()`` to a text exposition, both deterministic (sorted
    keys) so traces embedding them stay byte-stable.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any


def _key(name: str, labels: dict) -> str:
    """Canonical instrument key: ``name`` or ``name{k=v,...}`` with
    label keys sorted — deterministic and human-greppable."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count (shed requests, cache hits...)."""

    __slots__ = ("key", "value", "_lock")
    kind = "counter"

    def __init__(self, key: str):
        self.key = key
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Point-in-time level (queue depth, in-flight, breaker level)."""

    __slots__ = ("key", "value", "_lock")
    kind = "gauge"

    def __init__(self, key: str):
        self.key = key
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Streaming distribution: count/sum/min/max plus approximate
    quantiles over a bounded reservoir of the most recent samples
    (good enough for p50/p99 on serve latencies without unbounded
    memory)."""

    __slots__ = ("key", "count", "sum", "min", "max", "_recent", "_lock")
    kind = "histogram"

    def __init__(self, key: str, window: int = 2048):
        self.key = key
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._recent: deque = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._recent.append(v)

    def quantile(self, q: float) -> float | None:
        """Approximate quantile over the retained window."""
        with self._lock:
            data = sorted(self._recent)
        if not data:
            return None
        idx = min(len(data) - 1, max(0, int(round(q * (len(data) - 1)))))
        return data[idx]

    def snapshot(self) -> dict:
        with self._lock:
            n = self.count
            mean = self.sum / n if n else None
        return {
            "count": n,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": mean,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create registry of instruments, keyed by name + labels.

    Requesting an existing key with a different instrument kind is a
    bug and raises — silent type confusion would corrupt dashboards.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, Any] = {}

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = _key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(key, **kwargs)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {key!r} already registered as "
                    f"{inst.kind}, requested {cls.kind}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, window: int = 2048,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, window=window)

    # -- read side ----------------------------------------------------------

    def instruments(self) -> list:
        with self._lock:
            return [self._instruments[k]
                    for k in sorted(self._instruments)]

    def snapshot(self) -> dict:
        """``{key: value-or-stats-dict}``, keys sorted — the
        machine-readable exposition."""
        return {inst.key: inst.snapshot() for inst in self.instruments()}

    def find(self, prefix: str) -> dict:
        """Snapshot restricted to keys starting with ``prefix``
        (label'd variants included: ``serve_inflight`` matches
        ``serve_inflight{bucket=4}``)."""
        return {k: v for k, v in self.snapshot().items()
                if k.startswith(prefix)}

    def render(self) -> str:
        """Plain-text exposition, one instrument per line."""
        lines = []
        for inst in self.instruments():
            if inst.kind == "histogram":
                s = inst.snapshot()
                mean = s["mean"]
                lines.append(
                    f"{inst.key} count={s['count']} sum={s['sum']:.6g}"
                    + (f" mean={mean:.6g}" if mean is not None else "")
                    + (f" p50={s['p50']:.6g} p99={s['p99']:.6g}"
                       if s["p50"] is not None else ""))
            else:
                lines.append(f"{inst.key} {inst.snapshot():.6g}")
        return "\n".join(lines)
