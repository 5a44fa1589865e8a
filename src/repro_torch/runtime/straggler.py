"""Straggler detection: EWMA step-time monitor — the port's copy of
``repro/runtime/straggler.py``.

On a real pod this gates re-slicing / hot-spare swap decisions; here
the detection logic is the deliverable and is unit-tested.  A step is
flagged when its duration exceeds ``threshold`` x the EWMA of previous
steps (warmup steps excluded, since compilation dominates them).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float


class StragglerMonitor:
    def __init__(self, alpha: float = 0.1, threshold: float = 3.0,
                 warmup: int = 2):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: float | None = None
        self.times: list[float] = []
        self.events: list[StragglerEvent] = []
        self._n = 0

    def record(self, step: int, duration: float) -> bool:
        """Returns True when the step is a straggler."""
        self.times.append(duration)
        self._n += 1
        if self._n <= self.warmup:
            return False
        if self.ewma is None:
            self.ewma = duration
            return False
        is_straggler = duration > self.threshold * self.ewma
        if is_straggler:
            self.events.append(StragglerEvent(step, duration, self.ewma))
        else:
            # only fold non-outliers into the running mean
            self.ewma = (1 - self.alpha) * self.ewma \
                + self.alpha * duration
        return is_straggler
