"""Fault-tolerant serving loop over :class:`ImageServer` — the port's
copy of ``repro/serve/loop.py``.

:class:`ServingLoop` wraps the bucketed server in an explicit request
lifecycle, so a shed or failed request is a terminal state in the same
:class:`~repro_torch.serve.ledger.TrafficLedger` as a served one, never
a silent hang:

::

    submit ──▶ PENDING ──▶ DISPATCHED ──▶ DONE
                 │              │ ▲
                 │ projected    │ └─ retry (expo backoff + jitter,
                 │ wait > budget│       <= max_retries attempts)
                 ▼              ▼
                SHED          FAILED

Stages (each independently drivable):

  * **arrival** — :meth:`ServingLoop.submit` sheds a request at once
    when the projected queue wait (backlog x an EMA of measured
    dispatch service time) already exceeds its latency budget;
  * **dispatch** — ready groups (the server's bucketed FIFO policy) are
    attempted; a failing attempt is retried with exponential backoff and
    seeded jitter up to ``max_retries``, after which every member is
    FAILED; requests whose deadline lapsed while queued are SHED at pop
    time instead of dispatched;
  * **completion** — results land in the server's bounded window, the
    ledger is charged, and the lifecycle record turns terminal.

A :class:`CircuitBreaker` keeps the loop serving under persistent
faults: ``breaker_threshold`` consecutive dispatch failures degrade
the dispatch one rung down the server target's
:meth:`~repro_torch.core.exec_target.ExecTarget.ladder`, which in the
port is kernel -> account-only (planning and the ledger, no logits, no
launch: there is no rung between, so nothing steps from the kernel to
the plain version or a library call on the card); a success after
``breaker_cooldown_s`` steps back up.  Every degraded dispatch is
counted in the ledger.

Ways to run it:

  * :meth:`ServingLoop.pump` — one synchronous pass (deterministic
    under a :class:`~repro_torch.serve.faults.VirtualClock`);
  * :meth:`ServingLoop.run_sync` — pump, tick, repeat until every
    submitted request is terminal;
  * :meth:`ServingLoop.run_async` — asyncio loop: attempts run on
    worker threads, up to ``max_inflight`` at once, while the event
    loop admits and forms the next buckets.  The kernels' launches keep
    their one-thread contract (:mod:`repro_torch.kernels.lean`): each
    attempt's enqueue runs under
    :data:`~repro_torch.kernels.lean.LAUNCH_LOCK`
    (:meth:`ImageServer._execute`), and its wait for the card outside
    it;
  * :meth:`ServingLoop.drain` — shutdown: flushes queue and retry
    backlog to terminal states, honoring backoff spacing.

Fault injection (:mod:`repro_torch.serve.faults`) hooks the dispatch
stage.  Timekeeping is injectable end to end (``clock=``/``sleep=``):
the loop inherits the server's clock, and a clock with a ``sleep``
(a VirtualClock) absorbs backoff waits and injected delays.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import math
import random
import threading
import time

from repro_torch.core.exec_target import KERNEL, ExecTarget
from repro_torch.obs.tracer import NULL_SPAN
from repro_torch.serve.bucketing import ImageRequest
from repro_torch.serve.server import ImageServer, ServeResult


class RequestState(enum.Enum):
    PENDING = "pending"
    DISPATCHED = "dispatched"
    DONE = "done"
    SHED = "shed"
    FAILED = "failed"


TERMINAL_STATES = frozenset(
    {RequestState.DONE, RequestState.SHED, RequestState.FAILED})


@dataclasses.dataclass
class TrackedRequest:
    """One request's lifecycle record (rid-keyed in ``loop.requests``)."""

    rid: int
    n_images: int
    arrival: float
    deadline_s: float | None
    state: RequestState = RequestState.PENDING
    attempts: int = 0                  # dispatch attempts it rode
    result: ServeResult | None = None  # set iff DONE
    error: str | None = None           # set iff FAILED
    shed_reason: str | None = None     # set iff SHED
    terminal_at: float | None = None
    # the request's lifecycle span (begun at admission, ended at the
    # terminal transition — possibly on another thread); NULL_SPAN
    # when tracing is off
    span: object = dataclasses.field(default=NULL_SPAN, repr=False,
                                     compare=False)

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES


class CircuitBreaker:
    """Consecutive-failure breaker over the degradation ladder.

    ``ladder`` is the sequence of :class:`ExecTarget` rungs, best path
    first (default: the kernel's own ladder, kernel -> account-only).
    ``threshold`` consecutive failures step ``level`` down one rung;
    any success resets the failure count, and a success after
    ``cooldown_s`` at a degraded level steps back up one — a half-open
    recovery that re-probes the better path one dispatch at a time
    instead of thundering back.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 1.0,
                 ladder: tuple[ExecTarget, ...] | None = None):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.ladder = KERNEL.ladder() if ladder is None \
            else tuple(ladder)
        self.level = 0
        self.trips = 0
        self._consecutive = 0
        self._entered_at = -math.inf

    @property
    def mode(self) -> ExecTarget:
        return self.ladder[self.level]

    def record_failure(self, now: float) -> bool:
        """True when this failure tripped a degradation."""
        self._consecutive += 1
        if (self._consecutive >= self.threshold
                and self.level < len(self.ladder) - 1):
            self.level += 1
            self.trips += 1
            self._consecutive = 0
            self._entered_at = now
            return True
        return False

    def record_success(self, now: float) -> bool:
        """True when this success stepped recovery back up a level."""
        self._consecutive = 0
        if self.level > 0 and now - self._entered_at >= self.cooldown_s:
            self.level -= 1
            self._entered_at = now
            return True
        return False


@dataclasses.dataclass
class _Job:
    """One dispatch group in flight or awaiting retry."""

    group: list[ImageRequest]
    bucket: int
    attempts: int = 0
    next_at: float = 0.0


class ServingLoop:
    """Deadline-shedding, retrying, degrading front-end around an
    :class:`ImageServer`.

    ``deadline_s`` is the default per-request latency budget (None:
    never shed); ``service_estimate_s`` seeds the dispatch-time EMA
    the shed policy projects queue waits from (before any dispatch has
    been measured, a zero estimate admits everything).  ``clock``
    defaults to the wrapped server's clock; ``sleep`` defaults to the
    clock's own ``sleep`` when it has one (VirtualClock), else real
    sleeping.  All submissions should flow through :meth:`submit` —
    requests enqueued directly on the server are adopted with default
    deadline on first contact, so they still terminate.
    """

    def __init__(self, server: ImageServer, *,
                 deadline_s: float | None = 0.25,
                 max_retries: int = 2,
                 backoff_base_s: float = 0.05,
                 backoff_mult: float = 2.0,
                 jitter_frac: float = 0.1,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 max_inflight: int = 2,
                 service_estimate_s: float = 0.0,
                 service_alpha: float = 0.3,
                 fault_plan=None,
                 seed: int = 0,
                 clock=None,
                 sleep=None,
                 tracer=None,
                 metrics=None):
        self.server = server
        # observability rides the server's tracer/registry by default,
        # so loop lifecycle events and server dispatch spans land in
        # one trace and the ledger renders the loop's gauges
        self.tracer = server.tracer if tracer is None else tracer
        self.metrics = server.metrics if metrics is None else metrics
        self.deadline_s = deadline_s
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_mult = float(backoff_mult)
        self.jitter_frac = float(jitter_frac)
        self.max_inflight = max(1, int(max_inflight))
        # the breaker degrades downward from the server's own target:
        # a kernel server trips to account-only, an account-only one
        # never trips
        self.breaker = CircuitBreaker(breaker_threshold,
                                      breaker_cooldown_s,
                                      ladder=server.target.ladder())
        self.fault_plan = fault_plan
        self._rng = random.Random(seed)
        self._clock = server._clock if clock is None else clock
        self._sleep = getattr(self._clock, "sleep", time.sleep) \
            if sleep is None else sleep
        self._service_ema = float(service_estimate_s)
        self._service_alpha = float(service_alpha)
        self._lock = threading.RLock()
        self.requests: dict[int, TrackedRequest] = {}
        self._retry_jobs: list[_Job] = []
        self._attempt_seq = 0          # FaultPlan's dispatch index
        self._inflight = 0
        self._inflight_by_bucket: dict[int, int] = {}
        self.counters = {"submitted": 0, "done": 0, "shed": 0,
                         "failed": 0, "shed_admission": 0,
                         "shed_expired": 0, "dispatch_failures": 0,
                         "retries": 0, "peak_inflight": 0}

    # -- observability -----------------------------------------------------

    def _backlog_by_bucket(self) -> dict[int, int]:
        """Under lock: requests awaiting dispatch, keyed by the bucket
        they'd ride — queued arrivals at their covering bucket plus
        retry-job members at their job's bucket."""
        out: dict[int, int] = {}
        for r in self.server.queue.pending:
            b = self.server.queue.bucket_for(r.n_images)
            out[b] = out.get(b, 0) + 1
        for j in self._retry_jobs:
            out[j.bucket] = out.get(j.bucket, 0) + len(j.group)
        return out

    def _refresh_gauges(self) -> None:
        """Under lock: publish per-bucket in-flight/backlog levels
        into the shared registry (zeroing buckets that emptied, so a
        stale gauge never reports phantom work)."""
        backlog = self._backlog_by_bucket()
        seen = (set(backlog) | set(self._inflight_by_bucket)
                | set(self.server.queue.buckets))
        for b in seen:
            self.metrics.gauge("serve_backlog",
                               bucket=b).set(backlog.get(b, 0))
            self.metrics.gauge("serve_inflight", bucket=b).set(
                self._inflight_by_bucket.get(b, 0))
        self.metrics.gauge("serve_breaker_level").set(self.breaker.level)
        self.metrics.gauge("serve_retry_backlog").set(
            len(self._retry_jobs))

    @property
    def stats(self) -> dict:
        with self._lock:
            self._refresh_gauges()
            return {**self.counters,
                    "inflight": self._inflight,
                    "inflight_by_bucket": dict(self._inflight_by_bucket),
                    "backlog_by_bucket": self._backlog_by_bucket(),
                    "retry_backlog": len(self._retry_jobs),
                    "queue_depth": self.server.queue.depth,
                    "breaker_level": self.breaker.level,
                    "breaker_mode": self.breaker.mode.name,
                    "service_ema_s": self._service_ema}

    def state_of(self, rid: int) -> RequestState | None:
        t = self.requests.get(rid)
        return None if t is None else t.state

    def all_terminal(self) -> bool:
        with self._lock:
            return (all(t.terminal for t in self.requests.values())
                    and not self._retry_jobs
                    and not self.server.queue.depth
                    and not self._inflight)

    def projected_wait(self, now: float) -> float:
        """Queue-wait estimate for a request admitted *now*: dispatch
        groups ahead of it (queued + retrying + in flight) times the
        measured service-time EMA."""
        q = self.server.queue
        queued_groups = math.ceil(q.pending_images / q.max_bucket)
        backlog = queued_groups + len(self._retry_jobs) + self._inflight
        return backlog * self._service_ema

    # -- arrival stage -----------------------------------------------------

    def submit(self, images=None, *, n_images: int | None = None,
               deadline_s: float | None = None,
               now: float | None = None) -> int:
        """Admit (or immediately shed) one request; returns its rid.

        ``deadline_s`` overrides the loop default for this request."""
        with self._lock:
            now = self._clock() if now is None else now
            deadline = self.deadline_s if deadline_s is None \
                else deadline_s
            n = 1 if n_images is None else int(n_images)
            if images is not None:
                shaped = getattr(images, "shape", None)
                if shaped is not None and len(shaped) == 4:
                    n = int(shaped[0])
            self.counters["submitted"] += 1
            projected = self.projected_wait(now)
            if deadline is not None and projected > deadline:
                rid = self.server.reserve_rid()
                self.counters["shed_admission"] += 1
                t = TrackedRequest(rid=rid, n_images=n, arrival=now,
                                   deadline_s=deadline,
                                   span=self.tracer.begin("request",
                                                          rid=rid,
                                                          n_images=n))
                self._terminal_shed(
                    t, now, reason=f"projected wait {projected:.3f}s > "
                                   f"budget {deadline:.3f}s")
                return rid
            rid = self.server.submit(images, n_images=n_images, now=now)
            n = self._queued_n_images(rid, n)
            self.requests[rid] = TrackedRequest(
                rid=rid, n_images=n, arrival=now, deadline_s=deadline,
                span=self.tracer.begin("request", rid=rid, n_images=n))
            self._refresh_gauges()
            return rid

    def _queued_n_images(self, rid: int, fallback: int) -> int:
        for r in self.server.queue.pending:
            if r.rid == rid:
                return r.n_images
        return fallback

    def _adopt(self, req: ImageRequest) -> TrackedRequest:
        """Lifecycle record for a rid (lazily created for requests
        submitted directly on the server, so they too terminate)."""
        t = self.requests.get(req.rid)
        if t is None:
            t = TrackedRequest(rid=req.rid, n_images=req.n_images,
                               arrival=req.arrival,
                               deadline_s=self.deadline_s,
                               span=self.tracer.begin(
                                   "request", rid=req.rid,
                                   n_images=req.n_images, adopted=True))
            self.requests[req.rid] = t
        return t

    # -- terminal transitions ----------------------------------------------

    def _terminal(self, t: TrackedRequest, state: RequestState) -> None:
        """Shared terminal bookkeeping: close the lifecycle span and
        emit exactly one ``request.terminal`` event per rid — the
        span-tree mirror of the drop-free invariant."""
        self.tracer.end(t.span, state=state.value,
                        attempts=t.attempts)
        self.tracer.event("request.terminal", rid=t.rid,
                          state=state.value)

    def _terminal_shed(self, t: TrackedRequest, now: float, *,
                       reason: str) -> None:
        t.state = RequestState.SHED
        t.shed_reason = reason
        t.terminal_at = now
        self.requests[t.rid] = t
        self.counters["shed"] += 1
        self._terminal(t, RequestState.SHED)
        self.server.ledger.record_shed(
            t.rid, t.n_images, waited_s=max(0.0, now - t.arrival),
            reason=reason)

    def _terminal_failed(self, t: TrackedRequest, now: float,
                         error: str) -> None:
        t.state = RequestState.FAILED
        t.error = error
        t.terminal_at = now
        self.counters["failed"] += 1
        self._terminal(t, RequestState.FAILED)
        self.server.ledger.record_failed(
            t.rid, t.n_images, waited_s=max(0.0, now - t.arrival),
            error=error)

    def _shed_expired(self, group: list[ImageRequest], now: float
                      ) -> tuple[list[ImageRequest], int]:
        """Drop group members whose deadline already lapsed while
        queued (dispatching them would return a guaranteed timeout);
        survivors re-bucket to the smallest covering size."""
        survivors = []
        for r in group:
            t = self._adopt(r)
            waited = now - r.arrival
            if t.deadline_s is not None and waited > t.deadline_s:
                self.counters["shed_expired"] += 1
                self._terminal_shed(
                    t, now, reason=f"queued {waited:.3f}s > budget "
                                   f"{t.deadline_s:.3f}s")
            else:
                survivors.append(r)
        if not survivors:
            return [], 0
        total = sum(r.n_images for r in survivors)
        return survivors, self.server.queue.bucket_for(total)

    # -- dispatch stage ----------------------------------------------------

    def _next_job(self, now: float) -> _Job | None:
        """Under lock: the next attemptable job — a due retry first
        (FIFO by its backoff due-time), else a ready queue group with
        expired members shed."""
        due = [j for j in self._retry_jobs if j.next_at <= now]
        if due:
            job = min(due, key=lambda j: j.next_at)
            self._retry_jobs.remove(job)
            return job
        while (ready := self.server.queue.pop_ready(now)) is not None:
            group, bucket = self._shed_expired(ready[0], now)
            if group:
                return _Job(group=group, bucket=bucket)
        return None

    def _observe_service(self, dt: float) -> None:
        dt = max(0.0, dt)
        if self._service_ema <= 0.0:
            self._service_ema = dt
        else:
            a = self._service_alpha
            self._service_ema = (1 - a) * self._service_ema + a * dt

    def _attempt(self, job: _Job, now: float
                 ) -> tuple[str, list[ServeResult]]:
        """One dispatch attempt: returns ("done"|"retry"|"failed",
        completed results).  Bookkeeping runs under the loop lock; the
        fault delay and the pipeline execution run off-lock so
        concurrent attempts overlap them."""
        tr = self.tracer
        with self._lock:
            attempt_idx = self._attempt_seq
            self._attempt_seq += 1
            mode = self.breaker.mode
            tracked = [self._adopt(r) for r in job.group]
            for t in tracked:
                t.state = RequestState.DISPATCHED
                t.attempts += 1
            self._inflight += 1
            self._inflight_by_bucket[job.bucket] = (
                self._inflight_by_bucket.get(job.bucket, 0)
                + len(job.group))
            self.counters["peak_inflight"] = max(
                self.counters["peak_inflight"], self._inflight)
            self._refresh_gauges()
            t0 = self._clock()
        attempt_span = tr.begin(
            "dispatch.attempt", bucket=job.bucket, mode=mode.name,
            attempt=job.attempts + 1,
            rids=",".join(str(r.rid) for r in job.group))
        try:
            if self.fault_plan is not None:
                delay = self.fault_plan.before_dispatch(
                    attempt_idx, job.bucket, clock=self._clock)
                if delay > 0:
                    self._sleep(delay)
            logits = self.server._execute(job.group, job.bucket,
                                          target=mode)
        except Exception as e:  # noqa: BLE001 — any dispatch fault
            with self._lock:
                self._inflight -= 1
                self._inflight_by_bucket[job.bucket] -= len(job.group)
                done_at = self._clock()
                tr.end(attempt_span, outcome="error", error=repr(e))
                self._observe_service(done_at - t0)
                if self.breaker.record_failure(done_at):
                    tr.event("breaker.trip", level=self.breaker.level,
                             mode=self.breaker.mode.name)
                    self.metrics.counter("serve_breaker_trips").inc()
                self.counters["dispatch_failures"] += 1
                job.attempts += 1
                if job.attempts > self.max_retries:
                    for t in tracked:
                        self._terminal_failed(t, done_at, error=repr(e))
                    self._refresh_gauges()
                    return "failed", []
                backoff = (self.backoff_base_s
                           * self.backoff_mult ** (job.attempts - 1))
                backoff *= 1.0 + self.jitter_frac * self._rng.uniform(
                    -1.0, 1.0)
                job.next_at = done_at + max(backoff, 0.0)
                self._retry_jobs.append(job)
                self.counters["retries"] += 1
                self.metrics.counter("serve_retries").inc()
                tr.event("dispatch.retry", bucket=job.bucket,
                         attempt=job.attempts,
                         backoff_s=job.next_at - done_at)
                self._refresh_gauges()
                return "retry", []
        with self._lock:
            self._inflight -= 1
            self._inflight_by_bucket[job.bucket] -= len(job.group)
            done_at = self._clock()
            tr.end(attempt_span, outcome="done")
            results = self.server._complete(job.group, job.bucket,
                                            logits, now=now)
            self._observe_service(done_at - t0)
            if self.breaker.record_success(done_at):
                tr.event("breaker.recover", level=self.breaker.level,
                         mode=self.breaker.mode.name)
            if mode is not self.server.target:
                self.server.ledger.record_degraded(mode.name)
            for t, res in zip(tracked, results):
                t.state = RequestState.DONE
                t.result = res
                t.terminal_at = done_at
                self.counters["done"] += 1
                self._terminal(t, RequestState.DONE)
            self._refresh_gauges()
            return "done", results

    # -- running -----------------------------------------------------------

    def pump(self, now: float | None = None) -> list[ServeResult]:
        """One synchronous pass: attempt every due retry and every
        ready group.  Deterministic under a VirtualClock — the chaos
        suite drives exclusively through here."""
        out: list[ServeResult] = []
        now = self._clock() if now is None else now
        while True:
            with self._lock:
                job = self._next_job(now)
            if job is None:
                return out
            _, results = self._attempt(job, now)
            out.extend(results)

    def run_sync(self, *, tick_s: float = 0.005,
                 max_ticks: int = 100_000) -> list[ServeResult]:
        """Pump, advance the clock one tick, repeat — until every
        submitted request is terminal.  Under a VirtualClock the ticks
        are free; under a real clock this is a blocking mini-server."""
        out = self.pump()
        ticks = 0
        while not self.all_terminal():
            self._sleep(tick_s)
            out.extend(self.pump())
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"run_sync: non-terminal work after {ticks} ticks "
                    f"(stats {self.stats})")
        return out

    def drain(self, now: float | None = None) -> list[ServeResult]:
        """Mid-storm shutdown: flush the admission queue and the retry
        backlog all the way to terminal states.  Every remaining rid
        ends DONE, SHED (deadline lapsed while queued), or FAILED
        (retries exhausted) — nothing is dropped.  Backoff spacing is
        honored through ``sleep``, so a VirtualClock drains instantly."""
        out: list[ServeResult] = []
        with self._lock:
            now = self._clock() if now is None else now
            for group, _bucket in self.server.queue.drain():
                g, b = self._shed_expired(group, now)
                if g:
                    self._retry_jobs.append(
                        _Job(group=g, bucket=b, next_at=now))
            while self._retry_jobs:
                job = min(self._retry_jobs, key=lambda j: j.next_at)
                self._retry_jobs.remove(job)
                wait = job.next_at - self._clock()
                if wait > 0:
                    self._sleep(wait)
                _, results = self._attempt(job, self._clock())
                out.extend(results)
        return out

    async def run_async(self, *, tick_s: float = 0.001,
                        until_idle: bool = True
                        ) -> list[ServeResult]:
        """Asyncio loop with in-flight overlap: each attempt runs in
        a worker thread, at most ``max_inflight`` concurrently, while
        the event loop keeps admitting and forming the next buckets.
        Two attempts overlap their fault delays, bookkeeping and waits
        for the card, never their launches: the server enqueues each
        dispatch under :data:`~repro_torch.kernels.lean.LAUNCH_LOCK`.
        Returns once idle (``until_idle``) — all submitted work
        terminal and no task in flight."""
        sem = asyncio.Semaphore(self.max_inflight)
        tasks: set[asyncio.Task] = set()
        out: list[ServeResult] = []

        async def attempt_task(job: _Job, started_at: float) -> None:
            try:
                _, results = await asyncio.get_running_loop() \
                    .run_in_executor(None, self._attempt, job,
                                     started_at)
                out.extend(results)
            finally:
                sem.release()

        while True:
            with self._lock:
                now = self._clock()
                job = self._next_job(now)
            if job is None:
                if until_idle and not tasks and self.all_terminal():
                    break
                await asyncio.sleep(tick_s)
                continue
            await sem.acquire()
            task = asyncio.create_task(attempt_task(job, now))
            tasks.add(task)
            task.add_done_callback(tasks.discard)
        if tasks:
            await asyncio.gather(*tasks)
        return out
