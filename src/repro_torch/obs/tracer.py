"""Span-based tracer: the seconds half of the bytes-vs-seconds story.

The port's copy of ``repro/obs/tracer.py``; the Perfetto export is
:mod:`repro_torch.obs.export`.  The
:class:`~repro_torch.serve.ledger.TrafficLedger` says how many bytes a
plan moves; this tracer says where the wall-clock goes, with the
cheapest abstraction that still composes: a :class:`Span` is a named interval
``[t0, t1]`` with attributes (rid / bucket / layer / plan_key / bytes),
spans nest into a tree per thread, and the clock is injectable (lint
rule L005/L006) so the same spans that time a real kernel call replay
bit-identically under a virtual clock.

Design contract:

  * **zero-cost when off** — the default tracer everywhere is
    :data:`NULL_TRACER`, whose ``span()`` returns one shared no-op
    context manager and whose ``event()`` is a constant return;
  * **thread-safe** — records append under a lock, the parent stack is
    thread-local, and detached spans (:meth:`Tracer.begin` /
    :meth:`Tracer.end`) never touch any stack, so a request-lifecycle
    span can start on the submit thread and finish on a worker;
  * **both seconds and bytes** — instrumentation sites attach the
    plan-accounted ``traffic_bytes`` to kernel spans, so every span
    carries the achieved-GB/s numerator *and* denominator (the
    roofline's missing measurement substrate);
  * **injectable, never ambient-by-default** — call sites take
    ``tracer=`` and fall back to :func:`active_tracer`; the module
    global behind it is mutated only via :func:`set_active` /
    :meth:`Tracer.activate`, which lint rule L006 confines to this
    package (callers use the ``with tracer.activate():`` scope).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable

#: span kinds: a timed interval, or a zero-duration instant event
KIND_SPAN = "span"
KIND_INSTANT = "instant"


@dataclasses.dataclass
class Span:
    """One traced interval (or instant event, ``t1 == t0``).

    ``sid``/``parent`` encode the span tree; ``tid`` is the logical
    track (thread name) the span ran on.  ``attrs`` is open-ended —
    the serving conventions are ``rid``/``bucket``/``layer``/
    ``plan_key``/``traffic_bytes``."""

    sid: int
    parent: int | None
    name: str
    t0: float
    kind: str = KIND_SPAN
    t1: float | None = None
    tid: str = "main"
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float | None:
        """Seconds, or None while the span is still open."""
        return None if self.t1 is None else self.t1 - self.t0

    @property
    def finished(self) -> bool:
        return self.t1 is not None

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes; chainable."""
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """Shared no-op stand-in for :class:`Span` and its context
    manager — one instance serves every disabled call site."""

    __slots__ = ()
    sid = -1
    parent = None
    name = ""
    kind = KIND_SPAN
    t0 = 0.0
    t1 = 0.0
    tid = ""
    dur = 0.0
    finished = True

    @property
    def attrs(self) -> dict:
        return {}

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        return fn            # no-op decorator: the function unchanged

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """The zero-cost disabled tracer (default at every call site).

    Every method returns a constant; ``span()`` hands back the one
    shared :data:`NULL_SPAN` context manager, so instrumented code
    pays an attribute lookup and a call — nothing else."""

    __slots__ = ()
    active = False

    def now(self) -> float:
        return 0.0

    def span(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def event(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def begin(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def end(self, span, **attrs) -> _NullSpan:
        return NULL_SPAN

    @property
    def records(self) -> list:
        return []

    def find(self, name: str | None = None, **attrs) -> list:
        return []

    def activate(self) -> "_Activation":
        return _Activation(self)


NULL_TRACER = NullTracer()


class _SpanCtx:
    """Context manager *and* decorator for one :meth:`Tracer.span`.

    As a CM it opens a fresh stacked span on ``__enter__``; as a
    decorator it opens one per wrapped call — so
    ``@tracer.span("plan.search")`` and ``with tracer.span(...)``
    are the same instrumentation idiom."""

    __slots__ = ("_tracer", "_name", "_attrs", "_span")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._span: Span | None = None

    def __enter__(self) -> Span:
        self._span = self._tracer._open(self._name, dict(self._attrs),
                                        stacked=True)
        return self._span

    def __exit__(self, et, ev, tb) -> bool:
        span = self._span
        self._span = None
        if et is not None:
            span.set(error=repr(ev))
        self._tracer._close(span, stacked=True)
        return False

    def __call__(self, fn: Callable) -> Callable:
        tracer, name, attrs = self._tracer, self._name, self._attrs

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _SpanCtx(tracer, name, attrs):
                return fn(*args, **kwargs)
        return wrapper


class Tracer:
    """Span-tree tracer with an injectable clock.

    ``clock`` is any 0-arg callable returning seconds
    (``time.perf_counter`` default; a
    virtual clock makes every trace deterministic and replayable).
    Records (spans + instant events) accumulate in memory in begin
    order; export them with :mod:`repro_torch.obs.export`.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 *, enabled: bool = True, max_records: int = 1 << 20):
        self._clock = clock
        self.enabled = bool(enabled)
        self.max_records = int(max_records)
        self.dropped = 0          # records not kept past max_records
        self._lock = threading.Lock()
        self._records: list[Span] = []
        self._next_sid = 0
        self._local = threading.local()

    # -- core record-keeping ------------------------------------------------

    @property
    def active(self) -> bool:
        return self.enabled

    def now(self) -> float:
        return self._clock()

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, name: str, attrs: dict, *, stacked: bool) -> Span:
        stack = self._stack() if stacked else None
        parent = stack[-1].sid if stacked and stack else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            span = Span(sid=sid, parent=parent, name=name,
                        t0=self._clock(),
                        tid=threading.current_thread().name,
                        attrs=attrs)
            if len(self._records) < self.max_records:
                self._records.append(span)
            else:
                self.dropped += 1
        if stacked:
            stack.append(span)
        return span

    def _close(self, span: Span, *, stacked: bool) -> Span:
        if stacked:
            stack = self._stack()
            if stack and stack[-1] is span:
                stack.pop()
            elif span in stack:          # mis-nested exit: repair
                stack.remove(span)
        with self._lock:
            span.t1 = self._clock()
        return span

    # -- public API ---------------------------------------------------------

    def span(self, name: str, **attrs) -> _SpanCtx:
        """A nested span: context manager or decorator.  Parentage
        follows the per-thread enter/exit stack."""
        if not self.enabled:
            return NULL_SPAN
        return _SpanCtx(self, name, attrs)

    def begin(self, name: str, **attrs) -> Span:
        """Open a *detached* span (no parent stack): the caller owns
        the handle and ends it — possibly from another thread — with
        :meth:`end`.  The request-lifecycle idiom."""
        if not self.enabled:
            return NULL_SPAN
        return self._open(name, attrs, stacked=False)

    def end(self, span: Span, **attrs) -> Span:
        """Close a span from :meth:`begin` (idempotent on the null
        span), attaching any final attributes first."""
        if span is None or span is NULL_SPAN:
            return NULL_SPAN
        span.set(**attrs)
        return self._close(span, stacked=False)

    def event(self, name: str, **attrs) -> Span:
        """A zero-duration instant event at ``now()``, parented under
        this thread's currently-open span (if any)."""
        if not self.enabled:
            return NULL_SPAN
        span = self._open(name, attrs, stacked=False)
        stack = self._stack()
        if stack:
            span.parent = stack[-1].sid
        span.kind = KIND_INSTANT
        span.t1 = span.t0
        return span

    # -- queries ------------------------------------------------------------

    @property
    def records(self) -> list[Span]:
        """Snapshot of every span/event, in begin order."""
        with self._lock:
            return list(self._records)

    def find(self, name: str | None = None, **attrs) -> list[Span]:
        """Records matching a name and/or attribute equality filters."""
        out = []
        for s in self.records:
            if name is not None and s.name != name:
                continue
            if any(s.attrs.get(k) != v for k, v in attrs.items()):
                continue
            out.append(s)
        return out

    def tree(self) -> list[dict]:
        """The span forest as nested ``{"span", "children"}`` dicts
        (instant events included as leaves), roots in begin order."""
        nodes = {s.sid: {"span": s, "children": []}
                 for s in self.records}
        roots = []
        for s in self.records:
            node = nodes[s.sid]
            if s.parent is not None and s.parent in nodes:
                nodes[s.parent]["children"].append(node)
            else:
                roots.append(node)
        return roots

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0

    # -- ambient installation ----------------------------------------------

    def activate(self) -> "_Activation":
        """Scope this tracer as the process-wide ambient tracer
        (``with tracer.activate(): ...``) — the sanctioned way to
        reach instrumentation sites that cannot thread a ``tracer=``
        argument (e.g. the lru-cached ``plan_conv``)."""
        return _Activation(self)


# -- ambient tracer (mutated only here; lint rule L006) ---------------------

_ACTIVE: Tracer | NullTracer = NULL_TRACER
_ACTIVE_LOCK = threading.Lock()


def active_tracer() -> Tracer | NullTracer:
    """The ambient tracer (default: :data:`NULL_TRACER`).  Call sites
    use this as the fallback for ``tracer=None`` parameters."""
    return _ACTIVE


def set_active(tracer: Tracer | NullTracer | None):
    """Install ``tracer`` as the ambient tracer; returns the previous
    one.  Lint rule L006 confines direct calls to :mod:`repro_torch.obs` —
    everything else scopes the swap with ``with tracer.activate():``."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev = _ACTIVE
        _ACTIVE = NULL_TRACER if tracer is None else tracer
        return prev


class _Activation:
    """``with tracer.activate():`` — scoped ambient installation."""

    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer):
        self._tracer = tracer
        self._prev = None

    def __enter__(self):
        self._prev = set_active(self._tracer)
        return self._tracer

    def __exit__(self, *exc) -> bool:
        set_active(self._prev)
        return False


# -- timed-call helper (the benchmark substrate) ----------------------------

def timed_call(fn: Callable, *args, reps: int = 3, warmup: int = 1,
               tracer: Tracer | NullTracer | None = None,
               name: str = "timed_call",
               clock: Callable[[], float] = time.perf_counter,
               **attrs) -> float:
    """Synced mean microseconds per call of ``fn(*args)``.

    ``fn`` must block until its result is ready: on the card, end it
    with ``torch.cuda.synchronize()`` (this helper adds no sync), or the
    time is the host's enqueue, not the work.  Each rep records one span
    on ``tracer`` (ambient by default), timestamped by the *tracer's*
    clock but measured with ``clock``, so a virtual-clock trace still
    carries honest ``us`` attributes."""
    tr = active_tracer() if tracer is None else tracer
    for _ in range(max(0, warmup)):
        fn(*args)
    total = 0.0
    for _ in range(max(1, reps)):
        with tr.span(name, **attrs) as sp:
            t0 = clock()
            fn(*args)
            dt = clock() - t0
            sp.set(us=dt * 1e6)
        total += dt
    return total / max(1, reps) * 1e6
