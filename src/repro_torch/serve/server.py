"""Batched CNN inference server over the conv kernel — the port's copy
of ``repro/serve/server.py``.

Serves any conv network expressed as a
:class:`~repro_torch.models.graph.ConvGraph` (VGG is the default: a
server built from bare VGG params reconstructs its graph): bucketed
admission (:mod:`repro_torch.serve.bucketing`) pads arrival batches to
a bucket ladder, a per-bucket cache keeps one pipeline per bucket, and
a per-request traffic ledger (:mod:`repro_torch.serve.ledger`) charges
each request its share of the accounted words.

Two costs are cached and paid once per bucket:

  * *planning* — ``plan_conv`` is memoized on (batch, layer geometry);
  * *the pipeline* — one ``(bucket, H, W, C) -> logits`` callable per
    bucket, every conv of it the CUDA kernel on the card
    (``stats["traces"]`` counts how many were built).

An ``account-only`` server runs admission, bucketing, planning and the
ledger without executing anything: full-scale VGG16/224 serving
economics in milliseconds on any host.  A dispatch's ``target`` clamps
downward against the server's (:meth:`ExecTarget.clamp`), so the
serving loop's circuit breaker (:mod:`repro_torch.serve.loop`) can
degrade a kernel server's dispatch to account-only, never upgrade one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.exec_target import (KERNEL, ExecTarget,
                                          resolve_device, resolve_target)
from repro_torch.kernels.lean import LAUNCH_LOCK
from repro_torch.models.cnn import vgg_graph
from repro_torch.models.graph import ConvGraph, graph_logits, \
    graph_plan_handles
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve.bucketing import (DEFAULT_BUCKETS, AdmissionQueue,
                                         ImageRequest)
from repro_torch.serve.ledger import RequestCharge, TrafficLedger


#: the types a computing server runs K1 in
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

#: recent results kept for lookup; dispatch return values are the
#: durable hand-off, so a long-serving process does not pin every
#: logits tensor
KEEP_RESULTS = 1024


@dataclasses.dataclass
class ServeResult:
    """One completed request: logits per image + its traffic charge."""

    rid: int
    logits: Any                # (n_images, n_classes) tensor or None
    charge: RequestCharge
    latency_s: float


class ImageServer:
    """Bucketed, ledger-accounted image-classification server.

    ``params`` is the ``{"convs", "head"}`` dict of the served graph;
    ``graph=None`` reconstructs the VGG graph from the param shapes.
    Every request carries 1..max(buckets) images of the
    ``(h, w, in_ch)`` geometry.  A custom ``forward`` callable
    ``(params, images, target) -> logits`` replaces the generic
    :func:`graph_logits` pipeline (``target`` is the server's resolved
    :class:`~repro_torch.core.exec_target.ExecTarget`); it needs an
    explicit ``graph``, which the ledger charges.  ``account_budget``
    is the on-chip scale the ledger scores distance-to-bound at
    (default: the paper's 1 MiB GBuf).  ``dtype`` is the served word:
    the ledger charges ``dtype.itemsize`` bytes a word, as the
    reference does.  ``target`` is ``"kernel"`` (the default) or
    ``"account-only"``, the ceiling of every dispatch's target;
    ``device`` is where a computing server runs —
    ``cuda`` unless the caller asks for ``cpu``.  ``tracer`` (default:
    the no-op tracer) and ``metrics`` (default: a registry of this
    server's own) are shared with the ledger and any ServingLoop
    mounted on this server, so a caller can export one trace with the
    metrics it was run with.

    A computing server runs K1 in its ``dtype``, float32 or bfloat16
    (bf16 operands, f32 sums and epilogue, one rounding on store; the
    head a plain ``@`` in ``dtype``, as the reference's); another
    ``dtype`` with the generic pipeline raises at construction.  An
    account-only server serves any ``dtype``."""

    def __init__(self, params, h: int, w: int, in_ch: int = 3, *,
                 graph: ConvGraph | None = None,
                 forward=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 wait_budget: float = 0.02,
                 account_budget: int = 1 << 20,
                 dtype: torch.dtype = torch.float32,
                 target: ExecTarget | str = KERNEL,
                 device="cuda",
                 clock=time.monotonic,
                 tracer=None,
                 metrics: MetricsRegistry | None = None):
        self.params = params
        if graph is None and forward is not None:
            raise ValueError("a custom forward= needs an explicit graph= "
                             "(the ledger charges plan handles walked "
                             "from the graph, and only bare VGG params "
                             "can reconstruct one)")
        self.graph = vgg_graph(params) if graph is None else graph
        self._forward = forward
        self.h, self.w, self.in_ch = int(h), int(w), int(in_ch)
        self.target = resolve_target(target)
        if (self.target.compute and forward is None
                and dtype not in COMPUTE_DTYPES):
            raise ValueError(
                f"a computing {dtype} server needs K1 in {dtype}, which "
                f"takes float32 or bfloat16; serve {dtype} with "
                f"target='account-only', or pass a forward=")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.account_budget = int(account_budget)
        self._clock = clock
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.queue = AdmissionQueue(buckets, wait_budget)
        self.ledger = TrafficLedger(vmem_budget=account_budget,
                                    dtype_bytes=self.dtype.itemsize,
                                    metrics=self.metrics)
        self._handles: dict[tuple, list] = {}
        self._pipelines: dict[int, Any] = {}
        self.results: dict[int, ServeResult] = {}
        self._counters = {"dispatches": 0, "traces": 0,
                          "pipeline_hits": 0, "plan_hits": 0,
                          "results_evicted": 0}
        self._next_rid = 0

    @property
    def compute(self) -> bool:
        return self.target.compute

    @property
    def stats(self) -> dict:
        """Counters plus live queue gauges."""
        return {**self._counters,
                "queue_depth": self.queue.depth,
                "oldest_wait_s": self.queue.oldest_wait(self._clock())}

    # -- request intake ----------------------------------------------------

    def submit(self, images=None, *, n_images: int | None = None,
               now: float | None = None) -> int:
        """Enqueue one request; returns its rid.  ``images``: (n, H, W,
        C) or (H, W, C), a tensor or array; account-only servers may
        pass ``n_images`` alone."""
        now = self._clock() if now is None else now
        if images is None:
            if self.compute:
                raise ValueError("compute servers need image payloads")
            n = 1 if n_images is None else int(n_images)
        else:
            if isinstance(images, np.ndarray):
                images = torch.from_numpy(images)
            images = images.to(device=self.device, dtype=self.dtype)
            if images.dim() == 3:
                images = images[None]
            if tuple(images.shape[1:]) != (self.h, self.w, self.in_ch):
                raise ValueError(f"expected (*, {self.h}, {self.w}, "
                                 f"{self.in_ch}) images, got "
                                 f"{tuple(images.shape)}")
            n = int(images.shape[0])
            if n_images is not None and n_images != n:
                raise ValueError("n_images disagrees with payload")
        rid = self.reserve_rid()
        self.queue.submit(ImageRequest(rid=rid, n_images=n, arrival=now,
                                       images=images))
        self.tracer.event("serve.admit", rid=rid, n_images=n)
        self.metrics.counter("serve_admitted").inc()
        self.metrics.gauge("serve_queue_depth").set(self.queue.depth)
        return rid

    def reserve_rid(self) -> int:
        """Allocate the next request id without enqueueing anything:
        the serving loop's id for a request it sheds at admission, so
        admitted and shed work share one rid space."""
        rid = self._next_rid
        self._next_rid += 1
        return rid

    # -- bucket caches -----------------------------------------------------

    def plan_handles(self, bucket: int):
        """The (ConvLayer, ConvPlan) accounting handles for a bucket,
        keyed by the full plan identity (graph, bucket, image geometry,
        word size) and verified before they enter the cache."""
        key = (self.graph, int(bucket), self.h, self.w, self.in_ch,
               self.dtype.itemsize)
        if key not in self._handles:
            with self.tracer.span("plan.handles", bucket=int(bucket),
                                  model=self.graph.name,
                                  plan_key=f"{self.graph.name}/b{bucket}"
                                           f"/{self.h}x{self.w}"):
                self._handles[key] = graph_plan_handles(
                    self.graph, self.h, self.w, batch=bucket,
                    in_ch=self.in_ch, dtype_bytes=self.dtype.itemsize,
                    vmem_budget=self.account_budget, verify=True)
            self.metrics.counter("plan_cache_miss").inc()
        else:
            self._counters["plan_hits"] += 1
            self.tracer.event("plan.cache_hit", bucket=int(bucket),
                              model=self.graph.name)
            self.metrics.counter("plan_cache_hit").inc()
        return self._handles[key]

    def pipeline(self, bucket: int, target: ExecTarget | str | None = None):
        """The (bucket, H, W, C) -> logits callable, built once per
        bucket; ``target`` clamps against the server's, and an
        account-only one runs no pipeline (the kernel is the one target
        that computes)."""
        tgt = self.target.clamp(target)
        if not tgt.compute:
            raise ValueError(f"an {tgt.name} dispatch runs no pipeline")
        if bucket in self._pipelines:
            self._counters["pipeline_hits"] += 1
            return self._pipelines[bucket]
        self._counters["traces"] += 1
        graph, params, forward = self.graph, self.params, self._forward

        def fwd(imgs: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():     # serving records no backward
                if forward is not None:
                    return forward(params, imgs, tgt)
                return graph_logits(graph, params, imgs)

        self._pipelines[bucket] = fwd
        return fwd

    def warm(self, buckets: Sequence[int] | None = None) -> None:
        """Pre-plan (and, when computing, pre-run) the bucket ladder."""
        for b in buckets or self.queue.buckets:
            self.plan_handles(b)
            if self.compute:
                zeros = torch.zeros((b, self.h, self.w, self.in_ch),
                                    dtype=self.dtype, device=self.device)
                self.pipeline(b)(zeros)
        if self.compute and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- dispatch ----------------------------------------------------------

    def _execute(self, group: list[ImageRequest], bucket: int, *,
                 target: ExecTarget | str | None = None):
        """Run one dispatch's pipeline and wait for it: the compute half
        of a dispatch, which the serving loop calls off its lock.
        ``target`` clamps downward against the server's; at
        account-only this returns ``None`` and launches nothing."""
        tgt = self.target.clamp(target)
        if not tgt.compute:
            return None
        payload = torch.cat([r.images for r in group], dim=0)
        pad = bucket - payload.shape[0]
        if pad:
            payload = torch.cat([payload, payload.new_zeros(
                (pad,) + tuple(payload.shape[1:]))], dim=0)
        tr = self.tracer
        n_bytes = None
        if tr.active:
            n_bytes = sum(p.traffic(bucket).total
                          for _, p in self.plan_handles(bucket)) \
                * self.dtype.itemsize
        with tr.span("serve.execute", bucket=int(bucket), mode=tgt.name,
                     n_images=int(payload.shape[0]) - pad,
                     traffic_bytes=n_bytes) as sp:
            t0 = tr.now()
            with LAUNCH_LOCK:     # enqueue from one thread at a time
                out = self.pipeline(bucket, tgt)(payload)
            if out.is_cuda:       # the card's compute is in the span
                torch.cuda.synchronize(out.device)
            dt = tr.now() - t0
            sp.set(us=dt * 1e6)
        return out

    def _complete(self, group: list[ImageRequest], bucket: int, logits,
                  now: float) -> list[ServeResult]:
        """Bookkeeping half of a dispatch: stamp completion, charge the
        ledger, publish results into the bounded window."""
        done = max(self._clock(), now, *(r.arrival for r in group))
        for r in group:
            r.done = done
            self.tracer.event("serve.complete", rid=r.rid,
                              bucket=int(bucket))
        handles = self.plan_handles(bucket)
        entries = [(r.rid, r.n_images) for r in group]
        charges = self.ledger.charge_batch(
            entries, handles, bucket=bucket,
            latencies={r.rid: r.latency for r in group},
            model=self.graph.name)
        self._counters["dispatches"] += 1
        results = []
        off = 0
        for r, charge in zip(group, charges):
            sl = None if logits is None else logits[off:off + r.n_images]
            off += r.n_images
            res = ServeResult(rid=r.rid, logits=sl, charge=charge,
                              latency_s=r.latency)
            self.results[r.rid] = res
            results.append(res)
        # evict oldest-first, never a result this dispatch returns
        current = {r.rid for r in group}
        for rid in list(self.results):
            if len(self.results) <= KEEP_RESULTS:
                break
            if rid in current:
                continue
            del self.results[rid]
            self._counters["results_evicted"] += 1
        return results

    def _dispatch(self, group: list[ImageRequest], bucket: int,
                  now: float) -> list[ServeResult]:
        logits = self._execute(group, bucket)
        return self._complete(group, bucket, logits, now)

    def poll(self, now: float | None = None) -> list[ServeResult]:
        """Dispatch every ready group (full buckets immediately,
        partial ones past the wait budget)."""
        now = self._clock() if now is None else now
        out = []
        while (ready := self.queue.pop_ready(now)) is not None:
            out.extend(self._dispatch(*ready, now=now))
        return out

    def drain(self, now: float | None = None) -> list[ServeResult]:
        """Flush the queue to empty regardless of deadlines."""
        now = self._clock() if now is None else now
        out = []
        for ready in self.queue.drain():
            out.extend(self._dispatch(*ready, now=now))
        return out
