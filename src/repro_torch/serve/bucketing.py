"""Bucketed admission for the batched image server — the port's copy
of ``repro/serve/bucketing.py``.

The batch-folded conv plans are memoized per (batch, layer geometry):
every distinct arrival batch costs a plan search and a pipeline
build.  Admission therefore *buckets*: arrival batches are padded up
to a small ladder of plan-friendly batch sizes (default {1, 2, 4, 8}),
so the steady state touches only ``len(buckets)`` pipelines and every
``plan_conv`` lookup is a cache hit.

Policy (FIFO, head-of-line order preserved):

  * requests queue in arrival order; a dispatch group is the longest
    FIFO prefix whose image total fits the largest bucket;
  * a group dispatches immediately once it is *maximal* — its total
    hits the largest bucket, or the next pending request would
    overflow it (waiting cannot improve a FIFO prefix that can no
    longer grow);
  * otherwise the group waits for more arrivals until the oldest
    pending request has waited past ``wait_budget`` seconds, then the
    partial group is flushed and padded up to the smallest covering
    bucket (deadline-aware flush: tail latency is bounded by
    ``wait_budget`` + one pipeline execution).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Sequence

DEFAULT_BUCKETS = (1, 2, 4, 8)


def bucket_for(n_images: int, buckets: Sequence[int] = DEFAULT_BUCKETS
               ) -> int:
    """Smallest bucket covering ``n_images`` (the padding target).

    One-shot API over an arbitrary (possibly unsorted) ladder; hot
    paths go through :meth:`AdmissionQueue.bucket_for`, which reuses
    the ladder sorted once at construction."""
    for b in sorted(buckets):
        if n_images <= b:
            return b
    raise ValueError(f"{n_images} images exceed the largest bucket "
                     f"{max(buckets)}; split the request on submit")


@dataclasses.dataclass
class ImageRequest:
    """One inference request: ``n_images`` images classified together.

    ``images`` is the (n_images, H, W, C) payload, or None in
    account-only serving (planning + ledger without compute)."""

    rid: int
    n_images: int
    arrival: float
    images: Any = None
    done: float | None = None        # dispatch-completion timestamp

    @property
    def latency(self) -> float | None:
        """Seconds from arrival to dispatch completion, or ``None``
        while the request is still pending.  (Reporting 0.0 for
        in-flight work would silently deflate any latency percentile
        computed over a window that contains it.)"""
        return None if self.done is None else self.done - self.arrival


class AdmissionQueue:
    """FIFO queue with bucketed, deadline-aware group formation."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 wait_budget: float = 0.02):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.wait_budget = float(wait_budget)
        self.pending: Deque[ImageRequest] = deque()

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    @property
    def depth(self) -> int:
        return len(self.pending)

    @property
    def pending_images(self) -> int:
        return sum(r.n_images for r in self.pending)

    def oldest_wait(self, now: float) -> float:
        """Seconds the head-of-line request has waited (0.0 when
        empty; clamped — a skewed clock must not report negative)."""
        if not self.pending:
            return 0.0
        return max(0.0, now - self.pending[0].arrival)

    def bucket_for(self, n_images: int) -> int:
        """Smallest covering bucket, over the ladder sorted once in
        ``__init__`` (the module-level :func:`bucket_for` re-sorts its
        argument on every call — and silently mis-buckets custom
        ladders passed unsorted if the sort is forgotten)."""
        for b in self.buckets:
            if n_images <= b:
                return b
        raise ValueError(f"{n_images} images exceed the largest "
                         f"bucket {self.max_bucket}; split the "
                         "request on submit")

    def submit(self, req: ImageRequest) -> None:
        if req.n_images < 1:
            raise ValueError("empty request")
        if req.n_images > self.max_bucket:
            raise ValueError(f"request of {req.n_images} images exceeds "
                             f"the largest bucket {self.max_bucket}")
        self.pending.append(req)

    def _prefix(self) -> tuple[int, int]:
        """(count, images) of the longest FIFO prefix fitting the
        largest bucket."""
        count = total = 0
        for r in self.pending:
            if total + r.n_images > self.max_bucket:
                break
            total += r.n_images
            count += 1
        return count, total

    def _pop(self, count: int, total: int
             ) -> tuple[list[ImageRequest], int]:
        group = [self.pending.popleft() for _ in range(count)]
        return group, self.bucket_for(total)

    def pop_ready(self, now: float
                  ) -> tuple[list[ImageRequest], int] | None:
        """The next dispatchable (group, bucket), or None to keep
        waiting.  Call repeatedly until None to drain all ready work."""
        if not self.pending:
            return None
        count, total = self._prefix()
        maximal = (total == self.max_bucket
                   or count < len(self.pending))
        if maximal or now - self.pending[0].arrival >= self.wait_budget:
            return self._pop(count, total)
        return None

    def flush(self) -> tuple[list[ImageRequest], int] | None:
        """Force the *next group only* out regardless of deadline.

        One call pops at most one bucket's worth of requests — a
        shutdown path that calls ``flush()`` once can silently drop
        every trailing group.  Drain loops must iterate until ``None``
        (or use :meth:`drain`, which owns that loop)."""
        if not self.pending:
            return None
        return self._pop(*self._prefix())

    def drain(self):
        """Yield (group, bucket) until the queue is empty — the
        loop-until-``None`` contract around :meth:`flush` that every
        shutdown/drain call site must use so trailing requests are
        never dropped."""
        while (ready := self.flush()) is not None:
            yield ready
