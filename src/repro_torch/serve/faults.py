"""Deterministic, seeded fault injection for the serving loop — the
port's copy of ``repro/serve/faults.py`` (no JAX in it; copied, not
imported, so the port loads nothing of the reference).  One seed gives
one schedule in both packages: ``FaultPlan.random`` draws from
``random.Random`` in the reference's order.

The chaos suite's contract is *reproducibility*: a :class:`FaultPlan`
is a fixed schedule of events keyed by the global dispatch-attempt
index (attempt 0 is the first dispatch the loop ever tries, retries
included), so "dispatch 3 fails, dispatch 5 runs 80 ms slow, the
clock jumps back 200 ms at dispatch 7" replays bit-identically from
the same plan.  ``FaultPlan.random(seed)`` derives such a schedule
from one integer, which is how the property tests sweep failure
schedules without ever being flaky.

Three event kinds:

  * ``fail``  — the dispatch attempt raises :class:`InjectedFault`
                (transient by construction: a retry of the same group
                is a new attempt index and may succeed);
  * ``delay`` — the attempt consumes ``value`` extra seconds of
                service time (slept through the loop's injectable
                ``sleep``, so a :class:`VirtualClock` absorbs it
                without real waiting);
  * ``skew``  — the clock jumps by ``value`` seconds (negative:
                backwards) just before the attempt executes — the
                "flip the clock" scenario the no-negative-latency
                invariant is tested under.  Applied only to clocks
                exposing ``jump`` (i.e. :class:`VirtualClock`).

``FaultPlan.parse`` understands the ``--fault-plan`` CLI spec, e.g.
``"fail@1,fail@2,delay@4:0.08,skew@6:-0.2,service:0.05"`` or
``"random:7"``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Sequence


class InjectedFault(RuntimeError):
    """A failure injected by a :class:`FaultPlan` (transient)."""


class VirtualClock:
    """Injectable clock for deterministic loop tests and benchmarks.

    Callable like ``time.monotonic``; ``sleep`` advances it (so
    backoff waits and injected delays cost no wall time) and ``jump``
    skews it by a signed offset — the one operation a monotonic clock
    forbids, which is exactly why the loop must survive it.
    """

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def sleep(self, dt: float) -> None:
        self.now += max(float(dt), 0.0)

    def jump(self, dt: float) -> None:
        self.now += float(dt)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled event: fires on dispatch-attempt ``at``."""

    at: int
    kind: str                  # "fail" | "delay" | "skew"
    value: float = 0.0         # delay seconds / skew offset
    bucket: int | None = None  # restrict to one bucket (None: any)

    def __post_init__(self):
        if self.kind not in ("fail", "delay", "skew"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """A replayable schedule of dispatch faults.

    ``service_s`` is a uniform per-dispatch service time added to
    every attempt — under a :class:`VirtualClock` it is the load
    model that makes queues actually back up (account-only dispatch
    is otherwise free in virtual time, and nothing would ever shed).
    ``triggered`` logs every event that fired, in firing order.
    """

    def __init__(self, events: Sequence[FaultEvent] = (), *,
                 service_s: float = 0.0, name: str = "faults"):
        self.events = tuple(sorted(events, key=lambda e: e.at))
        self.service_s = float(service_s)
        self.name = name
        self.triggered: list[FaultEvent] = []
        self._by_at: dict[int, list[FaultEvent]] = {}
        for ev in self.events:
            self._by_at.setdefault(ev.at, []).append(ev)

    def __repr__(self) -> str:
        return (f"FaultPlan({self.name}: {len(self.events)} events, "
                f"service={self.service_s}s)")

    # -- loop hook ---------------------------------------------------------

    def before_dispatch(self, attempt: int, bucket: int,
                        clock=None) -> float:
        """Fire every event scheduled for this attempt; returns the
        service+delay seconds the attempt should consume.  A ``fail``
        event raises (fail-fast: the returned delay is then never
        slept); ``skew`` is applied here, directly to the clock."""
        delay = self.service_s
        failing = None
        for ev in self._by_at.get(attempt, ()):
            if ev.bucket is not None and ev.bucket != bucket:
                continue
            self.triggered.append(ev)
            if ev.kind == "delay":
                delay += ev.value
            elif ev.kind == "skew" and hasattr(clock, "jump"):
                clock.jump(ev.value)
            elif ev.kind == "fail":
                failing = ev
        if failing is not None:
            raise InjectedFault(
                f"injected dispatch failure (attempt {attempt}, "
                f"bucket {bucket})")
        return delay

    # -- constructors ------------------------------------------------------

    @classmethod
    def failures(cls, *attempts: int, **kw) -> "FaultPlan":
        """Fail exactly the given dispatch-attempt indices."""
        return cls([FaultEvent(at=a, kind="fail") for a in attempts],
                   **kw)

    @classmethod
    def random(cls, seed: int, *, n_dispatches: int = 32,
               p_fail: float = 0.15, p_delay: float = 0.2,
               max_delay_s: float = 0.1, p_skew: float = 0.05,
               max_skew_s: float = 0.25,
               service_s: float = 0.0) -> "FaultPlan":
        """A seed-deterministic schedule over the first
        ``n_dispatches`` attempts (the property-test sweep)."""
        rng = random.Random(seed)
        events = []
        for i in range(n_dispatches):
            r = rng.random()
            if r < p_fail:
                events.append(FaultEvent(at=i, kind="fail"))
            elif r < p_fail + p_delay:
                events.append(FaultEvent(
                    at=i, kind="delay",
                    value=rng.uniform(0.0, max_delay_s)))
            elif r < p_fail + p_delay + p_skew:
                events.append(FaultEvent(
                    at=i, kind="skew",
                    value=rng.uniform(-max_skew_s, max_skew_s)))
        return cls(events, service_s=service_s, name=f"random({seed})")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a ``--fault-plan`` spec.

        ``"random:SEED"`` or comma-joined tokens ``KIND@AT[:VALUE]``
        plus an optional ``service:SECONDS``, e.g.
        ``"fail@1,delay@3:0.05,skew@6:-0.2,service:0.01"``."""
        spec = spec.strip()
        if spec.startswith("random:"):
            return cls.random(int(spec.split(":", 1)[1]))
        events, service_s = [], 0.0
        for token in filter(None, (t.strip() for t in spec.split(","))):
            if token.startswith("service:"):
                service_s = float(token.split(":", 1)[1])
                continue
            head, _, value = token.partition(":")
            kind, _, at = head.partition("@")
            if not at:
                raise ValueError(f"bad fault token {token!r} "
                                 "(want KIND@AT[:VALUE])")
            events.append(FaultEvent(at=int(at), kind=kind,
                                     value=float(value) if value else 0.0))
        return cls(events, service_s=service_s, name=spec or "empty")
