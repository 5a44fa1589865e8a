"""The port's observability layer, held against the reference's.

The mirror of ``tests/test_obs.py`` at its small size (VGG width 0.05,
8x8 images): the span tracer, the metrics registry, the Perfetto/JSONL
export, ``timed_call``, the chaos suite's span-tree integrity, the
overhead budget of the disabled tracer, the instrumentation through
planning, ``conv2d_lb_timed`` and ``graph_forward``, the per-bucket
gauges, and the ``--trace`` flags of ``launch/serve_images.py`` and
``launch/train_vgg.py``.  Then parity with the reference:

  * ``write_trace`` of one seeded account-only chaos run (tracer and
    server on one ``VirtualClock``, one shared metrics registry): the
    port's Perfetto JSON and JSONL equal the reference's byte for byte;
  * ``graph_forward`` of the tiny VGG (weights carried across through
    ``convert.py``) under a virtual-clock tracer against the
    reference's ``graph_forward(target="lax")``: the ``graph.forward``,
    ``graph.layer`` and ``kernel.conv2d_lb`` records equal in names,
    order, parent links and attributes, apart from ``mode``;
  * ``conv2d_lb_timed`` over a geometry sweep: ``traffic_bytes`` equal
    to the reference's, and the output ``conv2d_lb``'s;
  * gradients through ``graph_forward`` with a tracer active equal
    those without one, bit for bit;
  * the three trace gaps of ``ImageServer`` the reference does not have:
    the ``plan.cache_hit`` event, the ``plan_key`` of ``plan.handles``
    and a ``metrics=`` registry shared with the ledger.
"""

import functools
import json
import random
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_lb import ops as jax_conv_ops
from repro.models.cnn import init_vgg as jax_init_vgg
from repro.models.cnn import vgg_graph as jax_vgg_graph
from repro.models.graph import graph_forward as jax_graph_forward
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.obs import Tracer as JaxTracer
from repro.obs import write_trace as jax_write_trace
from repro.serve import FaultPlan as JaxFaultPlan
from repro.serve import ImageServer as JaxImageServer
from repro.serve import ServingLoop as JaxServingLoop
from repro.serve import VirtualClock as JaxVirtualClock
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.conv_lb.ops import (conv2d_lb, conv2d_lb_timed,
                                            plan_conv)
from repro_torch.launch import serve_images, train_vgg
from repro_torch.models.cnn import init_vgg, vgg_graph
from repro_torch.models.graph import graph_forward
from repro_torch.obs import (MetricsRegistry, NULL_TRACER, Tracer,
                             active_tracer, chrome_trace, events_jsonl,
                             timed_call, write_trace)
from repro_torch.obs.tracer import NULL_SPAN
from repro_torch.serve import (FaultPlan, ImageServer, RequestState,
                               ServingLoop, VirtualClock)


@functools.lru_cache(maxsize=1)
def _tiny_params():
    return init_vgg(torch.Generator().manual_seed(0), n_classes=4,
                    width_mult=0.05, device="cpu")


@functools.lru_cache(maxsize=1)
def _jax_tiny_params():
    return jax_init_vgg(jax.random.PRNGKey(0), n_classes=4,
                        width_mult=0.05)


def _numpy_tree(params):
    return {"convs": [{k: np.asarray(v) for k, v in p.items()}
                      for p in params["convs"]],
            "head": np.asarray(params["head"])}


# --------------------------------------------------------------------------
# tracer core
# --------------------------------------------------------------------------

def test_span_nesting_and_attrs():
    ticks = iter(range(100))
    tr = Tracer(clock=lambda: float(next(ticks)))
    with tr.span("outer", rid=7) as outer:
        with tr.span("inner", layer="conv1") as inner:
            inner.set(traffic_bytes=123)
        tr.event("mark", bucket=4)
    outer_r, inner_r, ev = tr.records
    assert outer_r is outer and outer_r.parent is None
    assert inner_r.parent == outer_r.sid
    assert ev.parent == outer_r.sid and ev.kind == "instant"
    assert inner_r.attrs == {"layer": "conv1", "traffic_bytes": 123}
    assert (outer_r.t0, inner_r.t0, inner_r.t1, ev.t0) == (0.0, 1.0,
                                                           2.0, 3.0)
    assert outer_r.dur == outer_r.t1 - 0.0 and outer_r.finished
    assert ev.dur == 0.0


def test_span_decorator_and_error_capture():
    tr = Tracer()

    @tr.span("work", kindof="decorated")
    def work(x):
        return x + 1

    assert work(1) == 2 and work(2) == 3
    assert len(tr.find(name="work", kindof="decorated")) == 2
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("no")
    (sp,) = tr.find(name="boom")
    assert sp.finished and "no" in sp.attrs["error"]


def test_detached_begin_end_crosses_threads():
    tr = Tracer()
    sp = tr.begin("request", rid=1)
    t = threading.Thread(target=lambda: tr.end(sp, state="done"))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert sp.finished and sp.attrs["state"] == "done"
    assert sp.tid == "MainThread"
    assert tr.end(NULL_SPAN, state="x") is NULL_SPAN


def test_tracer_is_thread_safe_and_sids_unique():
    tr = Tracer()

    def pump(k):
        for i in range(200):
            with tr.span("t", worker=k, i=i):
                pass

    threads = [threading.Thread(target=pump, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = tr.records
    assert len(recs) == 1600 and tr.dropped == 0
    assert len({s.sid for s in recs}) == 1600
    assert all(s.finished for s in recs)


def test_max_records_drops_and_counts():
    tr = Tracer(max_records=5)
    for i in range(9):
        tr.event("e", i=i)
    assert len(tr.records) == 5 and tr.dropped == 4
    tr.clear()
    assert tr.records == [] and tr.dropped == 0


def test_tree_builds_the_span_forest():
    tr = Tracer()
    with tr.span("a"):
        with tr.span("b"):
            tr.event("c")
    with tr.span("d"):
        pass
    roots = tr.tree()
    assert [r["span"].name for r in roots] == ["a", "d"]
    (b,) = roots[0]["children"]
    assert b["span"].name == "b"
    assert [c["span"].name for c in b["children"]] == ["c"]


def test_null_tracer_is_inert_and_shared():
    assert NULL_TRACER.span("x", rid=1) is NULL_SPAN
    assert NULL_TRACER.event("x") is NULL_SPAN
    assert NULL_TRACER.begin("x") is NULL_SPAN
    assert not NULL_SPAN and NULL_SPAN.set(a=1) is NULL_SPAN
    assert NULL_SPAN.attrs == {}
    with NULL_SPAN as sp:
        assert sp is NULL_SPAN

    def f(x):
        return x

    assert NULL_SPAN(f) is f
    assert NULL_TRACER.records == [] and not NULL_TRACER.active
    off = Tracer(enabled=False)
    assert off.span("x") is NULL_SPAN and off.records == []


def test_activate_scopes_the_ambient_tracer():
    assert active_tracer() is NULL_TRACER
    tr = Tracer()
    with tr.activate() as got:
        assert got is tr and active_tracer() is tr
        inner = Tracer()
        with inner.activate():
            assert active_tracer() is inner
        assert active_tracer() is tr
    assert active_tracer() is NULL_TRACER


def test_timed_call_records_synced_us():
    ticks = iter(x * 0.001 for x in range(100))
    tr = Tracer()
    us = timed_call(lambda: None, reps=3, warmup=1, tracer=tr,
                    name="bench", clock=lambda: next(ticks))
    assert us == pytest.approx(1000.0)
    spans = tr.find(name="bench")
    assert len(spans) == 3
    assert all(s.attrs["us"] == pytest.approx(1000.0) for s in spans)


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------

def test_metrics_get_or_create_and_canonical_keys():
    reg = MetricsRegistry()
    c = reg.counter("serve_shed", reason="deadline")
    c.inc()
    c.inc(2.0)
    assert reg.counter("serve_shed", reason="deadline") is c
    assert c.key == "serve_shed{reason=deadline}"
    g = reg.gauge("depth", bucket=4, model="vgg")
    assert reg.gauge("depth", model="vgg", bucket=4) is g
    assert g.key == "depth{bucket=4,model=vgg}"
    g.set(3)
    g.inc()
    g.dec(2)
    assert g.snapshot() == 2.0
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("serve_shed", reason="deadline")


def test_histogram_stats_and_quantiles():
    reg = MetricsRegistry()
    h = reg.histogram("lat", bucket=8)
    for v in range(1, 101):
        h.observe(float(v))
    s = h.snapshot()
    assert s["count"] == 100 and s["sum"] == pytest.approx(5050.0)
    assert (s["min"], s["max"]) == (1.0, 100.0)
    assert s["mean"] == pytest.approx(50.5)
    assert s["p50"] == pytest.approx(50.0, abs=1.0)
    assert s["p99"] == pytest.approx(99.0, abs=1.0)
    small = reg.histogram("w", window=4)
    for v in (1.0, 2.0, 3.0, 4.0, 100.0):
        small.observe(v)
    assert small.count == 5 and small.quantile(1.0) == 100.0
    assert small.quantile(0.0) == 2.0


def test_snapshot_find_and_render_are_deterministic():
    reg = MetricsRegistry()
    reg.counter("b").inc()
    reg.gauge("a", bucket=2).set(1.5)
    reg.histogram("c").observe(0.25)
    snap = reg.snapshot()
    assert list(snap) == sorted(snap)
    assert snap["a{bucket=2}"] == 1.5
    assert reg.find("a") == {"a{bucket=2}": 1.5}
    text = reg.render()
    assert "a{bucket=2} 1.5" in text and "c count=1" in text


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------

def test_chrome_trace_shape_and_unfinished_spans():
    ticks = iter(range(100))
    tr = Tracer(clock=lambda: float(next(ticks)))
    with tr.span("done", rid=1):
        tr.event("mark")
    tr.begin("crashed", rid=2)
    reg = MetricsRegistry()
    reg.counter("served").inc(3)
    doc = chrome_trace(tr, reg)
    by_ph = {}
    for e in doc["traceEvents"]:
        by_ph.setdefault(e["ph"], []).append(e)
    assert set(by_ph) == {"X", "i", "M"}
    done = next(e for e in by_ph["X"] if e["name"] == "done")
    assert done["ts"] == 0.0 and done["dur"] == 2e6
    crashed = next(e for e in by_ph["X"] if e["name"] == "crashed")
    assert crashed["dur"] == 0.0 and crashed["args"]["unfinished"]
    assert by_ph["M"][0]["args"]["name"] == "MainThread"
    assert doc["otherData"]["metrics"]["served"] == 3
    assert doc["otherData"]["dropped_records"] == 0
    tr.event("odd", shape=(1, 2))
    assert chrome_trace(tr)["traceEvents"][0]
    json.dumps(chrome_trace(tr), sort_keys=True)


def test_events_jsonl_round_trips():
    tr = Tracer()
    with tr.span("a", rid=1):
        tr.event("b")
    lines = events_jsonl(tr).strip().splitlines()
    objs = [json.loads(line) for line in lines]
    assert [o["name"] for o in objs] == ["a", "b"]
    assert objs[1]["parent"] == objs[0]["sid"]


def _chaos_episode(seed, submissions, clock, loop, sleep):
    """The reference test's seeded chaos schedule, for either package."""
    rng = random.Random(seed)
    for _ in range(submissions):
        loop.submit(n_images=rng.randint(1, 8))
        if rng.random() < 0.5:
            loop.pump()
        if rng.random() < 0.3:
            sleep(round(rng.random(), 3) * 0.05)
    loop.run_sync(tick_s=0.01)


def _chaos_run(seed, submissions=20):
    """One seeded account-only chaos serve with full tracing;
    deterministic because tracer and server share one VirtualClock."""
    clock = VirtualClock()
    tracer = Tracer(clock=clock)
    metrics = MetricsRegistry()
    server = ImageServer(_tiny_params(), 8, 8, target="account-only",
                         device="cpu", clock=clock, wait_budget=0.01,
                         tracer=tracer, metrics=metrics)
    loop = ServingLoop(server, deadline_s=0.2,
                       fault_plan=FaultPlan.random(seed, service_s=0.02),
                       service_estimate_s=0.02, seed=seed)
    _chaos_episode(seed, submissions, clock, loop, clock.sleep)
    return loop, server, tracer, metrics


def _jax_chaos_run(seed, submissions=20):
    """The reference's ``_chaos_run`` (``tests/test_obs.py``)."""
    clock = JaxVirtualClock()
    tracer = JaxTracer(clock=clock)
    metrics = JaxMetricsRegistry()
    server = JaxImageServer(_jax_tiny_params(), 8, 8, compute=False,
                            clock=clock, wait_budget=0.01,
                            tracer=tracer, metrics=metrics)
    loop = JaxServingLoop(server, deadline_s=0.2,
                          fault_plan=JaxFaultPlan.random(seed,
                                                         service_s=0.02),
                          service_estimate_s=0.02, seed=seed)
    _chaos_episode(seed, submissions, clock, loop, clock.sleep)
    return loop, server, tracer, metrics


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_trace_export_is_bit_identical_per_seed(tmp_path, seed):
    paths = []
    for run in ("a", "b"):
        _, server, tracer, metrics = _chaos_run(seed)
        paths.append(write_trace(tmp_path / f"{run}.json", tracer,
                                 metrics))
    a, b = paths
    assert a.read_bytes() == b.read_bytes()
    assert (Path(str(a) + ".jsonl").read_bytes()
            == Path(str(b) + ".jsonl").read_bytes())
    doc = json.loads(a.read_text())
    assert len(doc["traceEvents"]) > 20


@pytest.mark.parametrize("seed", range(6))
def test_trace_export_equals_reference_bytes(tmp_path, seed):
    """The port's Perfetto JSON and JSONL of a seeded account-only chaos
    run are the reference's, byte for byte."""
    _, _, tracer, metrics = _chaos_run(seed)
    _, _, jtracer, jmetrics = _jax_chaos_run(seed)
    ours = write_trace(tmp_path / "ours.json", tracer, metrics)
    ref = jax_write_trace(tmp_path / "ref.json", jtracer, jmetrics)
    assert len(tracer.records) == len(jtracer.records) > 20
    assert ours.read_bytes() == ref.read_bytes()
    assert (Path(str(ours) + ".jsonl").read_bytes()
            == Path(str(ref) + ".jsonl").read_bytes())


# --------------------------------------------------------------------------
# span-tree integrity under chaos (the drop-free invariant, traced)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_chaos_every_rid_has_exactly_one_terminal_span(seed):
    loop, server, tracer, metrics = _chaos_run(seed)
    assert loop.all_terminal()
    c = loop.counters
    spans = tracer.find(name="request")
    assert len(spans) == c["submitted"]
    by_rid = {}
    for sp in spans:
        assert sp.finished, sp
        assert by_rid.setdefault(sp.attrs["rid"], sp) is sp
    terminals = tracer.find(name="request.terminal")
    assert len(terminals) == c["submitted"]
    for rid, t in loop.requests.items():
        assert by_rid[rid].attrs["state"] == t.state.value
    states = [sp.attrs["state"] for sp in spans]
    assert states.count(RequestState.DONE.value) == c["done"]
    assert states.count(RequestState.SHED.value) == c["shed"]
    assert states.count(RequestState.FAILED.value) == c["failed"]
    led = server.ledger.summary()
    snap = metrics.snapshot()
    assert snap.get("serve_served", 0) == led["served_requests"]
    shed = sum(v for k, v in snap.items() if k.startswith("serve_shed"))
    assert shed == led["shed_requests"]
    assert snap.get("serve_failed", 0) == led["failed_requests"]


def test_chaos_breaker_and_retry_events_fire_when_counted():
    loop, _, tracer, _ = _chaos_run(3)
    c = loop.counters
    assert len(tracer.find(name="dispatch.retry")) == c["retries"]
    attempts = tracer.find(name="dispatch.attempt")
    assert attempts and all(s.finished for s in attempts)
    assert (sum(s.attrs["outcome"] == "error" for s in attempts)
            == c["retries"] + c["failed"] > 0)


# --------------------------------------------------------------------------
# overhead budget: tracing off must stay ~free
# --------------------------------------------------------------------------

def test_noop_overhead_under_two_percent_of_serve_smoke():
    n = 20000
    t0 = time.perf_counter()
    for i in range(n):
        with NULL_TRACER.span("x", rid=i):
            pass
        NULL_TRACER.event("y", rid=i)
    per_site = (time.perf_counter() - t0) / (2 * n)
    w0 = time.perf_counter()
    _, _, tracer, _ = _chaos_run(11)
    wall = time.perf_counter() - w0
    sites = len(tracer.records) + tracer.dropped
    assert sites > 50
    assert sites * per_site < 0.02 * wall, (
        f"{sites} sites x {per_site * 1e6:.2f}us disabled cost vs "
        f"{wall * 1e3:.1f}ms smoke")


# --------------------------------------------------------------------------
# instrumentation through planning / kernels / graphs / serving
# --------------------------------------------------------------------------

def test_plan_search_span_rides_the_ambient_tracer():
    tr = Tracer()
    with tr.activate():
        # a geometry no other test uses: an lru-cache miss
        plan_conv(19, 19, 5, 7, 3, 3, batch=2)
    (sp,) = tr.find(name="plan.search")
    assert sp.finished and sp.attrs["layer"] == "5->7k3x3"
    assert "blocks" in sp.attrs
    with tr.activate():
        plan_conv(19, 19, 5, 7, 3, 3, batch=2)
    assert len(tr.find(name="plan.search")) == 1


def test_conv2d_lb_timed_attaches_bytes_and_seconds():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 8, 8, 4), generator=g)
    w = torch.randn((3, 3, 4, 4), generator=g)
    tr = Tracer()
    out = conv2d_lb_timed(x, w, padding=1, tracer=tr)
    ref = conv2d_lb(x, w, padding=1)
    assert torch.equal(out, ref)
    (sp,) = tr.find(name="kernel.conv2d_lb")
    assert sp.attrs["mode"] == "kernel"
    assert sp.attrs["traffic_bytes"] > 0
    assert sp.attrs["us"] > 0
    assert sp.attrs["achieved_gbps"] == pytest.approx(
        sp.attrs["traffic_bytes"] / (sp.attrs["us"] / 1e6) / 1e9)
    # a CPU tensor has no device time to record
    assert "device_us" not in sp.attrs
    assert torch.equal(conv2d_lb_timed(x, w, padding=1), ref)


def test_graph_forward_emits_per_layer_spans():
    params = _tiny_params()
    g = vgg_graph(params)
    x = torch.randn((1, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    tr = Tracer()
    graph_forward(g, params["convs"], x, tracer=tr)
    (fwd,) = tr.find(name="graph.forward")
    assert fwd.attrs["mode"] == "kernel"
    layers = tr.find(name="graph.layer")
    assert len(layers) == len(g.nodes)
    assert all(s.parent == fwd.sid for s in layers)
    kernels = tr.find(name="kernel.conv2d_lb")
    assert len(kernels) == len(g.nodes)
    assert [k.parent for k in kernels] == [s.sid for s in layers]
    assert all(s.attrs["traffic_bytes"] > 0 for s in kernels)
    # inside a torch.jit trace spans would time tracing, not running
    tr2 = Tracer()
    torch.jit.trace(lambda q: graph_forward(g, params["convs"], q,
                                            tracer=tr2), x,
                    check_trace=False)
    assert tr2.find(name="graph.forward") == []
    assert tr2.records == []


def test_graph_forward_with_another_conv_gets_layer_spans_only():
    from repro_torch.kernels.conv_lb.ref import conv2d_ref

    params = _tiny_params()
    g = vgg_graph(params)
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    tr = Tracer()
    out = graph_forward(g, params["convs"], x, conv=conv2d_ref, tracer=tr)
    assert torch.equal(out, graph_forward(g, params["convs"], x,
                                          conv=conv2d_ref))
    (fwd,) = tr.find(name="graph.forward")
    assert fwd.attrs["mode"] == "conv2d_ref"
    assert len(tr.find(name="graph.layer")) == len(g.nodes)
    assert tr.find(name="kernel.conv2d_lb") == []


# --------------------------------------------------------------------------
# parity with the reference: per-layer spans, bytes, gradients
# --------------------------------------------------------------------------

_LAYER_NAMES = ("graph.forward", "graph.layer", "kernel.conv2d_lb")


def _layer_records(tracer):
    out = []
    for s in tracer.records:
        if s.name not in _LAYER_NAMES:
            continue
        attrs = {k: v for k, v in s.attrs.items() if k != "mode"}
        out.append((s.sid, s.parent, s.name, s.kind, s.t0, s.t1, attrs))
    return out


def test_graph_forward_spans_equal_reference():
    jparams = _jax_tiny_params()
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    tr = Tracer(clock=VirtualClock())
    jtr = JaxTracer(clock=JaxVirtualClock())
    out = graph_forward(vgg_graph(params), params["convs"],
                        torch.from_numpy(x), tracer=tr)
    ref = jax_graph_forward(jax_vgg_graph(jparams), jparams["convs"],
                            jnp.asarray(x), target="lax", tracer=jtr)
    ours, theirs = _layer_records(tr), _layer_records(jtr)
    assert len(ours) == 1 + 2 * 13
    assert ours == theirs
    assert {s.attrs["mode"] for s in tr.records
            if s.name != "graph.layer"} == {"kernel"}
    ref = np.asarray(ref)
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max()


#: (b, h, ci, co, k, stride, pad, dilation, groups, relu, pool, residual)
TIMED_SWEEP = [
    (2, 9, 4, 8, 3, 1, 1, 1, 1, True, 1, False),
    (2, 9, 4, 8, 3, 2, 1, 1, 1, True, 1, False),
    (1, 16, 8, 16, 3, 2, 0, 1, 1, False, 1, False),
    (2, 8, 8, 8, 3, 1, 1, 1, 2, True, 1, False),
    (2, 8, 4, 8, 3, 1, 1, 1, 1, True, 2, False),
    (2, 8, 4, 8, 3, 1, 1, 1, 1, True, 1, True),
    (1, 12, 8, 12, 3, 1, 1, 1, 1, True, 2, True),
    (1, 11, 4, 4, 3, 1, 2, 2, 1, False, 1, False),
    (3, 7, 6, 10, 1, 1, 0, 1, 1, True, 1, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TIMED_SWEEP,
                         ids=[f"g{i}" for i in range(len(TIMED_SWEEP))])
def test_conv2d_lb_timed_bytes_equal_reference(case, dtype):
    b, h, ci, co, k, s, p, d, groups, relu, pool, res = case
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, h, h, ci)).astype(np.float32)
    w = rng.standard_normal((k, k, ci // groups, co)).astype(np.float32)
    bias = rng.standard_normal((co,)).astype(np.float32)
    ho = (h + 2 * p - d * (k - 1) - 1) // s + 1
    r = (rng.standard_normal((b, ho, ho, co)).astype(np.float32)
         if res else None)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)

    def t(a):
        return None if a is None else torch.from_numpy(a).to(tdt)

    def j(a):
        return None if a is None else jnp.asarray(a, dtype=jdt)

    kw = dict(stride=s, padding=p, dilation=d, groups=groups, relu=relu,
              pool=pool)
    tr, jtr = Tracer(), JaxTracer()
    out = conv2d_lb_timed(t(x), t(w), t(bias), t(r), tracer=tr, **kw)
    jax_conv_ops.conv2d_lb_timed(j(x), j(w), j(bias), j(r),
                                 fallback=True, tracer=jtr, **kw)
    (sp,), (jsp,) = tr.records, jtr.records
    assert sp.attrs["traffic_bytes"] == jsp.attrs["traffic_bytes"] > 0
    assert sp.attrs["layer"] == jsp.attrs["layer"]
    assert sp.attrs["batch"] == jsp.attrs["batch"] == b
    assert torch.equal(out, conv2d_lb(t(x), t(w), t(bias), t(r), **kw))


def test_traced_gradients_equal_untraced():
    params = _tiny_params()
    g = vgg_graph(params)
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(2))
    leaves = [t for conv in params["convs"] for t in conv.values()]
    grads = []
    for tracer in (None, Tracer()):
        ws = [t.detach().clone().requires_grad_(True) for t in leaves]
        it = iter(ws)
        convs = [{k: next(it) for k in conv} for conv in params["convs"]]
        xx = x.clone().requires_grad_(True)
        out = graph_forward(g, convs, xx, tracer=tracer)
        (out * out).sum().backward()
        grads.append([xx.grad] + [w.grad for w in ws])
    assert len(tracer.find(name="kernel.conv2d_lb")) == 13
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the server's trace: the three gaps to the reference
# --------------------------------------------------------------------------

def test_plan_handles_emits_cache_hit_event():
    tr = Tracer()
    srv = ImageServer(_tiny_params(), 8, 8, target="account-only",
                      device="cpu", tracer=tr)
    srv.plan_handles(4)
    assert tr.find(name="plan.cache_hit") == []
    with tr.span("outer") as outer:
        srv.plan_handles(4)
    (ev,) = tr.find(name="plan.cache_hit")
    assert ev.kind == "instant" and ev.parent == outer.sid
    assert ev.attrs == {"bucket": 4, "model": srv.graph.name}
    assert srv.metrics.snapshot()["plan_cache_hit"] == 1


def test_plan_handles_span_carries_plan_key():
    tr = Tracer()
    srv = ImageServer(_tiny_params(), 8, 8, target="account-only",
                      device="cpu", tracer=tr)
    srv.plan_handles(2)
    (sp,) = tr.find(name="plan.handles")
    assert sp.attrs == {"bucket": 2, "model": srv.graph.name,
                        "plan_key": f"{srv.graph.name}/b2/8x8"}


def test_server_uses_the_metrics_it_is_given():
    reg = MetricsRegistry()
    srv = ImageServer(_tiny_params(), 8, 8, target="account-only",
                      device="cpu", metrics=reg, wait_budget=0.0)
    assert srv.metrics is reg and srv.ledger.metrics is reg
    srv.submit(n_images=3)
    srv.drain()
    snap = reg.snapshot()
    assert snap["serve_admitted"] == 1 and snap["serve_served"] == 1
    assert ImageServer(_tiny_params(), 8, 8, target="account-only",
                       device="cpu").metrics is not reg


# --------------------------------------------------------------------------
# per-bucket gauges + ledger summary rendering
# --------------------------------------------------------------------------

def test_per_bucket_gauges_track_backlog_and_inflight():
    clock = VirtualClock()
    server = ImageServer(_tiny_params(), 8, 8, target="account-only",
                         device="cpu", clock=clock, wait_budget=10.0)
    loop = ServingLoop(server, deadline_s=60.0)
    loop.submit(n_images=3)
    stats = loop.stats
    b = server.queue.bucket_for(3)
    assert stats["backlog_by_bucket"] == {b: 1}
    assert stats["inflight_by_bucket"].get(b, 0) == 0
    assert (server.metrics.gauge("serve_backlog", bucket=b)
            .snapshot() == 1)
    assert f"b{b}: 0 in-flight / 1 backlog" in \
        server.ledger.format_summary()
    clock.sleep(11.0)
    loop.pump()
    stats = loop.stats
    assert stats["backlog_by_bucket"] == {}
    assert all(v == 0 for v in stats["inflight_by_bucket"].values())
    assert "backlog" not in server.ledger.format_summary()


# --------------------------------------------------------------------------
# --trace launchers end to end
# --------------------------------------------------------------------------

def test_launch_serve_images_trace_flag(tmp_path, capsys):
    out = tmp_path / "serve.json"
    serve_images.main(["--account-only", "--device", "cpu",
                       "--requests", "5", "--deadline", "0.5",
                       "--fault-plan", "random:3", "--trace", str(out)])
    assert "trace:" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    events = doc["traceEvents"]
    assert {e["ph"] for e in events} <= {"X", "i", "M"}
    terminals = [e for e in events if e["name"] == "request.terminal"]
    assert len(terminals) == 5
    by_state = {}
    for e in terminals:
        by_state[e["args"]["state"]] = by_state.get(e["args"]["state"],
                                                    0) + 1
    served = doc["otherData"]["metrics"].get("serve_served", 0)
    assert by_state.get("done", 0) == served
    jsonl = Path(str(out) + ".jsonl")
    assert jsonl.exists()
    assert all(json.loads(line) for line in jsonl.read_text().splitlines())
    # an account-only run rides the virtual clock: the same bytes again
    again = tmp_path / "again.json"
    serve_images.main(["--account-only", "--device", "cpu",
                       "--requests", "5", "--deadline", "0.5",
                       "--fault-plan", "random:3", "--trace", str(again)])
    assert again.read_bytes() == out.read_bytes()


def test_launch_train_vgg_trace_flag(tmp_path, capsys):
    out = tmp_path / "train.json"
    train_vgg.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                    "--image", "8", "--trace", str(out)])
    assert "trace:" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    assert "train.step" in names
    assert "graph.training_report" in names
    # the eager step's forward holds the per-layer spans
    assert names.count("graph.layer") == names.count("kernel.conv2d_lb") \
        == 13
    assert active_tracer() is NULL_TRACER


def test_serving_logits_traced_equal_untraced():
    """A traced computing dispatch (the tracer ambient, per-layer spans
    under ``serve.execute``) returns the untraced dispatch's logits."""
    params = _tiny_params()
    x = torch.randn((4, 8, 8, 3), generator=torch.Generator().manual_seed(5))
    plain = ImageServer(params, 8, 8, device="cpu")
    plain.submit(x)
    (want,) = plain.drain()
    tr = Tracer()
    srv = ImageServer(params, 8, 8, device="cpu", tracer=tr)
    with tr.activate():
        srv.submit(x)
        (got,) = srv.drain()
    assert torch.equal(got.logits, want.logits)
    (ex,) = tr.find(name="serve.execute")
    (fwd,) = tr.find(name="graph.forward")
    assert fwd.parent == ex.sid
    layers = tr.find(name="graph.layer")
    assert len(layers) == 13 and all(s.parent == fwd.sid for s in layers)
