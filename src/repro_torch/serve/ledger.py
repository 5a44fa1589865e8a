"""Per-request traffic ledger for the batched image server — the
port's copy of ``repro/serve/ledger.py``, the serving loop's terminal
states (shed, failed, degraded) included.

Every dispatch moves a knowable number of words:
:meth:`ConvPlan.traffic` gives each plan's volume analytically.  The
charged plans are the server's *accounting* handles, normalized to one
on-chip budget (default: the paper's 1 MiB GBuf), exactly as the
reference charges them; the CUDA kernel tiles for the card on its own,
so the ledger is a budget-normalized model of the dispatch, not a
counter on the card.  Each request in a dispatch group is charged its
image-proportional share (padding waste is borne by the real
requests).

Three observables per request / per horizon:

  * ``vs_bound_x``       — accounted bytes vs Eq. (15) at the realized
                           plan footprints;
  * ``w_amortization_x`` — accounted weight bytes per image vs the
                           per-image planner (b_block=1, closed form):
                           how much of the batch-reuse term the
                           bucketing recovered;
  * ``vs_serving_x``     — accounted bytes vs the serving-horizon bound
                           :func:`~repro_torch.core.lower_bound.q_dram_serving`.

Shed and failed requests carry no charge, but sit in the same ledger
as the served ones, so goodput and shed fraction are over every
submitted request (:meth:`TrafficLedger.summary`'s health fields).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Sequence

from repro_torch.core.lower_bound import q_dram_serving
from repro_torch.kernels.conv_lb.ops import exec_fallback_counts, plan_conv
from repro_torch.obs.metrics import MetricsRegistry


#: per-request charges kept (latency percentiles are over this window)
KEEP_CHARGES = 4096


@dataclasses.dataclass(frozen=True)
class RequestCharge:
    """One request's share of one dispatch's accounted traffic."""

    rid: int
    images: int
    bucket: int
    group_images: int          # real images in the dispatch group
    bytes_total: float
    bytes_weights: float
    bound_bytes: float         # Eq. (15) share at the dispatch batch
    latency_s: float | None = None   # None: not (yet) measured

    @property
    def vs_bound_x(self) -> float:
        return self.bytes_total / max(self.bound_bytes, 1e-30)


@dataclasses.dataclass
class _GeometryTally:
    """Per layer-stack-geometry running totals (horizon accounting):
    footprints per bucket, images amortizing jointly across buckets."""

    layers_b1: list            # ConvLayer at batch=1, per stage
    residuals: list            # per stage: a fused join reads its plane
    model: str | None = None
    footprints: dict = dataclasses.field(default_factory=dict)
    images_by_bucket: dict = dataclasses.field(default_factory=dict)
    baseline_w_words: float | None = None   # per-image, b_block=1 plan
    sum_bytes: float = 0.0
    sum_bound: float = 0.0
    requests: int = 0

    @property
    def images(self) -> int:
        return sum(self.images_by_bucket.values())


class TrafficLedger:
    """Charges dispatches to requests; summarizes distance-to-bound.

    ``vmem_budget`` is the accounting scale, used only for the
    per-image baseline plans — charged traffic always comes from the
    dispatch's own plan handles.  Totals are running aggregates;
    per-request charges are kept in a window of ``KEEP_CHARGES``."""

    def __init__(self, *, vmem_budget: int = 1 << 20,
                 dtype_bytes: int = 4,
                 metrics: MetricsRegistry | None = None):
        self.vmem_budget = int(vmem_budget)
        self.dtype_bytes = int(dtype_bytes)
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.charges: deque[RequestCharge] = deque(maxlen=KEEP_CHARGES)
        self.dispatches = 0
        self.padded_images = 0
        self._geos: dict[tuple, _GeometryTally] = {}
        self._sum_bytes = self._sum_w = self._sum_bound = 0.0
        self._n_requests = self._n_images = 0
        # terminal states of the serving loop: no charge, but counted
        self.shed_requests = self.shed_images = 0
        self.failed_requests = self.failed_images = 0
        self.degraded_dispatches = 0

    @staticmethod
    def _geo_key(handles) -> tuple:
        return tuple((l.name, l.hi, l.wi, l.ci, l.co, l.hk, l.wk,
                      l.stride, l.pad, bool(p.residual))
                     for l, p in handles)

    def _tally(self, handles, bucket: int,
               model: str | None) -> _GeometryTally:
        key = self._geo_key(handles)
        if key not in self._geos:
            self._geos[key] = _GeometryTally(
                layers_b1=[dataclasses.replace(l, batch=1)
                           for l, _ in handles],
                residuals=[bool(p.residual) for _, p in handles],
                model=model)
        tally = self._geos[key]
        tally.footprints.setdefault(
            bucket, [p.footprint_elems() for _, p in handles])
        return tally

    def charge_batch(self, entries: Sequence[tuple[int, int]], handles,
                     *, bucket: int,
                     latencies: dict[int, float] | None = None,
                     model: str | None = None
                     ) -> list[RequestCharge]:
        """Account one dispatch: ``entries`` is [(rid, n_images)] for
        the real requests in the group, ``handles`` the
        [(ConvLayer, ConvPlan)] pairs at batch == ``bucket``."""
        n_real = sum(n for _, n in entries)
        if n_real < 1 or n_real > bucket:
            raise ValueError(f"group of {n_real} images in a "
                             f"bucket-{bucket} dispatch")
        total_w = total_all = bound_w = 0.0
        for layer, plan in handles:
            t = plan.traffic(bucket)
            total_all += t.total
            total_w += t.reads_w
            bound_w += plan.bound_words(layer)
        db = self.dtype_bytes
        tally = self._tally(handles, bucket, model)
        tally.images_by_bucket[bucket] = (
            tally.images_by_bucket.get(bucket, 0) + n_real)
        tally.sum_bytes += total_all * db
        tally.sum_bound += bound_w * db * n_real / bucket
        tally.requests += len(entries)
        self.dispatches += 1
        self.padded_images += bucket - n_real
        out = []
        for rid, n in entries:
            charge = RequestCharge(
                rid=rid, images=n, bucket=bucket, group_images=n_real,
                bytes_total=total_all * db * n / n_real,
                bytes_weights=total_w * db * n / n_real,
                bound_bytes=bound_w * db * n / bucket,
                latency_s=(latencies or {}).get(rid))
            self.charges.append(charge)
            self._sum_bytes += charge.bytes_total
            self._sum_w += charge.bytes_weights
            self._sum_bound += charge.bound_bytes
            self._n_requests += 1
            self._n_images += n
            out.append(charge)
            if charge.latency_s is not None \
                    and not math.isnan(charge.latency_s):
                self.metrics.histogram("serve_latency_s",
                                       bucket=bucket).observe(
                                           charge.latency_s)
        self.metrics.counter("serve_served").inc(len(entries))
        self.metrics.counter("serve_bytes",
                             bucket=bucket).inc(total_all * db)
        return out

    # -- terminal states (serving-loop health) -----------------------------

    def record_shed(self, rid: int, n_images: int, *,
                    waited_s: float | None = None,
                    reason: str = "deadline") -> None:
        """One request shed by the deadline policy: terminal without a
        dispatch, so no charge, only its slot in the served + shed +
        failed reconciliation."""
        del rid, waited_s      # identity kept by the loop
        self.shed_requests += 1
        self.shed_images += int(n_images)
        self.metrics.counter("serve_shed", reason=reason).inc()

    def record_failed(self, rid: int, n_images: int, *,
                      waited_s: float | None = None,
                      error: str | None = None) -> None:
        """One request whose dispatch exhausted every retry."""
        del rid, waited_s, error
        self.failed_requests += 1
        self.failed_images += int(n_images)
        self.metrics.counter("serve_failed").inc()

    def record_degraded(self, mode: str) -> None:
        """One dispatch the circuit breaker served below the server's
        target (in the port: account-only, which computes nothing)."""
        self.degraded_dispatches += 1
        self.metrics.counter("serve_degraded", mode=mode).inc()

    @property
    def submitted_requests(self) -> int:
        """Every request that reached a terminal state: served (has a
        charge) + shed + failed."""
        return (self._n_requests + self.shed_requests
                + self.failed_requests)

    def _baseline_w_words(self, tally: _GeometryTally) -> float:
        """Per-image weight words of the per-image (b_block=1)
        closed-form planner."""
        if tally.baseline_w_words is None:
            words = 0.0
            for layer in tally.layers_b1:
                plan = plan_conv(layer.hi, layer.wi, layer.ci, layer.co,
                                 layer.hk, layer.wk, batch=1,
                                 stride=(layer.stride,) * 2,
                                 padding=(layer.pad,) * 2,
                                 dtype_bytes=self.dtype_bytes,
                                 vmem_budget=self.vmem_budget,
                                 autotune=False)
                words += plan.traffic(1).reads_w
            tally.baseline_w_words = words
        return tally.baseline_w_words

    @property
    def total_bytes(self) -> float:
        return self._sum_bytes

    @property
    def total_images(self) -> int:
        return self._n_images

    def _health(self) -> dict:
        """Terminal-state reconciliation, goodput and shed fraction over
        every submitted request, and the conv op's library-rung tally
        (:func:`~repro_torch.kernels.conv_lb.ops.exec_fallback_counts`):
        a nonzero ``exec_fallbacks`` means some conv pass left the
        kernels for cuDNN."""
        submitted = self.submitted_requests
        fallbacks = exec_fallback_counts()
        return {
            "exec_fallbacks": sum(fallbacks.values()),
            "exec_fallbacks_by_pass": fallbacks,
            "served_requests": self._n_requests,
            "shed_requests": self.shed_requests,
            "failed_requests": self.failed_requests,
            "submitted_requests": submitted,
            "shed_images": self.shed_images,
            "failed_images": self.failed_images,
            "goodput": self._n_requests / max(submitted, 1),
            "shed_frac": self.shed_requests / max(submitted, 1),
            "degraded_dispatches": self.degraded_dispatches,
        }

    def summary(self) -> dict:
        if not self._n_requests:
            return {"requests": 0, "images": 0, "dispatches": 0,
                    **self._health()}
        images = self._n_images
        total = self._sum_bytes
        weights = self._sum_w
        bound = self._sum_bound
        db = self.dtype_bytes
        baseline_w = horizon = 0.0
        by_model: dict[str, dict] = {}
        for tally in self._geos.values():
            baseline_w += self._baseline_w_words(tally) * tally.images
            # weights amortize over the geometry's whole horizon, each
            # bucket's images are bounded at that bucket's footprints;
            # a fused residual join adds its per-image plane read
            for bucket, n_imgs in sorted(tally.images_by_bucket.items()):
                horizon += sum(
                    q_dram_serving(layer, s, requests=tally.images)
                    + (layer.n_outputs if resid else 0)
                    for layer, s, resid in zip(tally.layers_b1,
                                               tally.footprints[bucket],
                                               tally.residuals)
                ) * n_imgs
            label = tally.model or "unlabeled"
            row = by_model.setdefault(
                label, {"requests": 0, "images": 0, "bytes": 0.0,
                        "bound_bytes": 0.0})
            row["requests"] += tally.requests
            row["images"] += tally.images
            row["bytes"] += tally.sum_bytes
            row["bound_bytes"] += tally.sum_bound
        for row in by_model.values():
            row["bytes_per_image"] = row["bytes"] / max(row["images"], 1)
            row["vs_bound_x"] = row["bytes"] / max(row["bound_bytes"],
                                                   1e-30)
        lat = sorted(c.latency_s for c in self.charges
                     if c.latency_s is not None
                     and not math.isnan(c.latency_s))
        return {
            "requests": self._n_requests,
            "images": images,
            "dispatches": self.dispatches,
            "padded_images": self.padded_images,
            "bytes_per_image": total / images,
            "weight_bytes_per_image": weights / images,
            "vs_bound_x": total / max(bound, 1e-30),
            "w_amortization_x": baseline_w * db / max(weights, 1e-30),
            "vs_serving_x": total / max(horizon * db, 1e-30),
            "measured_latencies": len(lat),
            "p50_latency_s": lat[len(lat) // 2] if lat else float("nan"),
            "p99_latency_s": (lat[min(len(lat) - 1,
                                      max(0, math.ceil(0.99 * len(lat))
                                          - 1))]
                              if lat else float("nan")),
            "max_latency_s": lat[-1] if lat else float("nan"),
            "by_model": by_model,
            **self._health(),
        }

    def _health_line(self, s: dict) -> str:
        line = (f"  health: goodput {s['goodput'] * 100:.1f}% "
                f"({s['served_requests']} ok / {s['shed_requests']} "
                f"shed / {s['failed_requests']} failed)")
        if s["degraded_dispatches"]:
            line += f", {s['degraded_dispatches']} degraded dispatches"
        if s["exec_fallbacks"]:
            by = ", ".join(f"{k} x{v}" for k, v in
                           sorted(s["exec_fallbacks_by_pass"].items()))
            line += (f"\n  exec fallbacks: {s['exec_fallbacks']} "
                     f"conv pass(es) left the kernels for the library "
                     f"rung ({by})")
        return line

    def _gauge_lines(self) -> str:
        """Per-bucket in-flight/backlog gauges (fed by the serving loop
        through the shared registry), one line per bucket with live
        work; empty when nothing is in flight."""
        inflight = self.metrics.find("serve_inflight{")
        backlog = self.metrics.find("serve_backlog{")
        buckets = sorted(
            {int(k.split("bucket=")[1].rstrip("}"))
             for k in list(inflight) + list(backlog)})
        parts = []
        for b in buckets:
            inf = inflight.get(f"serve_inflight{{bucket={b}}}", 0)
            bkl = backlog.get(f"serve_backlog{{bucket={b}}}", 0)
            if inf or bkl:
                parts.append(f"b{b}: {inf:g} in-flight / "
                             f"{bkl:g} backlog")
        if not parts:
            return ""
        return "\n  buckets: " + ", ".join(parts)

    def format_summary(self) -> str:
        s = self.summary()
        if not s["requests"]:
            if s["submitted_requests"]:
                return ("ledger: no traffic charged\n"
                        + self._health_line(s) + self._gauge_lines())
            return "ledger: no traffic charged" + self._gauge_lines()
        out = (f"ledger: {s['requests']} req / {s['images']} img in "
               f"{s['dispatches']} dispatches (+{s['padded_images']} pad)\n"
               f"  {s['bytes_per_image'] / 1e6:.2f} MB/img "
               f"({s['weight_bytes_per_image'] / 1e6:.2f} MB weights)\n"
               f"  vs Eq.(15) bound     {s['vs_bound_x']:.3f}x\n"
               f"  weight amortization  {s['w_amortization_x']:.2f}x "
               f"vs per-image dispatch\n"
               f"  vs serving horizon   {s['vs_serving_x']:.3f}x\n"
               f"  latency p50/p99/max  {s['p50_latency_s'] * 1e3:.1f}/"
               f"{s['p99_latency_s'] * 1e3:.1f}/"
               f"{s['max_latency_s'] * 1e3:.1f} ms\n"
               + self._health_line(s) + self._gauge_lines())
        for label, row in sorted(s["by_model"].items()):
            out += (f"\n  [{label}] {row['images']} img, "
                    f"{row['bytes_per_image'] / 1e6:.2f} MB/img, "
                    f"{row['vs_bound_x']:.3f}x bound")
        return out
