"""The port's fault-tolerant serving loop, held against the reference's.

The mirror of ``tests/test_serve_loop.py`` at its small size (VGG width
0.05, 8x8 images): lifecycle, deadline shedding, retry/backoff, the
circuit breaker (whose ladder in the port is kernel -> account-only:
a degraded dispatch plans and charges the ledger, and computes
nothing), drain mid-storm, clock skew, the chaos suite's drop-free
invariant, ``run_async`` and the fault plumbing.  Then:

  * parity — both loops account-only on a ``VirtualClock``, the same
    submissions and ``FaultPlan.random(seed)``: per-rid terminal states
    and attempts, the counters (retries, trips) and the ledger summaries
    equal, compared exactly;
  * the reference benchmark's bursty VGG16/224 trace through the port:
    its rows equal ``bench_serve_loop_bursty()``'s;
  * compute on the CPU — a tiny VGG, weights carried across through
    ``convert.py``, the reference loop at ``target="lax"`` and the
    port's at the kernel target (the plain version on a CPU tensor):
    DONE logits within 1e-5 of max |ref|;
  * ``run_async`` never runs two dispatches' enqueues at once (the
    kernels' one-thread launch contract), while attempts overlap;
  * the ``launch/serve_images.py`` CLI with ``--deadline`` /
    ``--fault-plan``, and the reference's lint rule L005 (no bare clock
    or sleep call) over the port's ``serve/``.
"""

import asyncio
import dataclasses
import functools
import importlib.util
import math
import random
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.analysis.lint import lint_file
from repro.kernels.conv_lb import ops as jax_conv_ops
from repro.models.cnn import init_vgg as jax_init_vgg
from repro.serve import FaultPlan as JaxFaultPlan
from repro.serve import ImageServer as JaxImageServer
from repro.serve import ServingLoop as JaxServingLoop
from repro.serve import VirtualClock as JaxVirtualClock
from repro_torch.convert import params_from_numpy
from repro_torch.core.exec_target import ACCOUNT_ONLY, KERNEL
from repro_torch.kernels.conv_lb import kernel as torch_kernel
from repro_torch.kernels.conv_lb import ops as torch_conv_ops
from repro_torch.launch import serve_images
from repro_torch.models.cnn import init_vgg, vgg_graph
from repro_torch.models.graph import graph_logits
from repro_torch.serve import (CircuitBreaker, FaultEvent, FaultPlan,
                               ImageServer, InjectedFault, RequestState,
                               ServingLoop, VirtualClock)

REPO = Path(__file__).resolve().parent.parent


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _tiny_params():
    return init_vgg(torch.Generator().manual_seed(0), n_classes=4,
                    width_mult=0.05, device="cpu")


@functools.lru_cache(maxsize=1)
def _jax_tiny_params():
    return jax_init_vgg(jax.random.PRNGKey(0), n_classes=4,
                        width_mult=0.05)


def _account_server(clock, **kw):
    kw.setdefault("wait_budget", 0.01)
    return ImageServer(_tiny_params(), 8, 8, target="account-only",
                       device="cpu", clock=clock, **kw)


def _compute_server(**kw):
    return ImageServer(_tiny_params(), 8, 8, device="cpu", **kw)


def _assert_reconciled(loop):
    """The drop-free invariant: every rid terminal exactly once, and
    the ledger's terminal-state rows match the loop's counters."""
    assert loop.all_terminal()
    c = loop.counters
    assert c["done"] + c["shed"] + c["failed"] == c["submitted"]
    states = [t.state for t in loop.requests.values()]
    assert len(states) == c["submitted"]
    assert sum(s is RequestState.DONE for s in states) == c["done"]
    assert sum(s is RequestState.SHED for s in states) == c["shed"]
    assert sum(s is RequestState.FAILED for s in states) == c["failed"]
    led = loop.server.ledger
    assert led.submitted_requests == c["submitted"]
    assert led.shed_requests == c["shed"]
    assert led.failed_requests == c["failed"]
    s = led.summary()
    assert s["served_requests"] == c["done"]
    assert s["goodput"] == pytest.approx(
        c["done"] / max(c["submitted"], 1))
    # no negative latency may ever be charged, skew or not
    for ch in led.charges:
        assert ch.latency_s is None or ch.latency_s >= 0.0


# --------------------------------------------------------------------------
# lifecycle basics
# --------------------------------------------------------------------------

def test_full_bucket_lifecycle_all_done():
    clock = VirtualClock()
    loop = ServingLoop(_account_server(clock), deadline_s=1.0)
    rids = [loop.submit(n_images=n) for n in (4, 2, 1, 1)]
    for rid in rids:
        assert loop.state_of(rid) is RequestState.PENDING
    results = loop.pump()                 # 4+2+1+1 == full 8-bucket
    assert sorted(r.rid for r in results) == sorted(rids)
    assert all(loop.state_of(r) is RequestState.DONE for r in rids)
    assert all(loop.requests[r].attempts == 1 for r in rids)
    _assert_reconciled(loop)
    assert loop.counters["done"] == 4
    assert loop.server.ledger.summary()["goodput"] == 1.0


def test_direct_server_submissions_are_adopted():
    """Requests enqueued on the server behind the loop's back still
    get a lifecycle record and terminate."""
    clock = VirtualClock()
    srv = _account_server(clock)
    loop = ServingLoop(srv, deadline_s=1.0)
    rid = srv.submit(n_images=8)          # bypasses loop.submit
    loop.pump()
    assert loop.state_of(rid) is RequestState.DONE
    assert loop.all_terminal()


# --------------------------------------------------------------------------
# deadline shedding
# --------------------------------------------------------------------------

def test_admission_sheds_when_projected_wait_exceeds_budget():
    """A storm beyond capacity sheds at admission, and every shed rid
    is terminal with a ledger row."""
    clock = VirtualClock()
    loop = ServingLoop(_account_server(clock), deadline_s=0.1,
                       fault_plan=FaultPlan(service_s=0.05),
                       service_estimate_s=0.05, seed=0)
    rids = [loop.submit(n_images=1) for _ in range(24)]
    shed = [r for r in rids if loop.state_of(r) is RequestState.SHED]
    assert shed and len(shed) == loop.counters["shed_admission"]
    for rid in shed:
        assert "projected wait" in loop.requests[rid].shed_reason
    loop.run_sync(tick_s=0.01)
    _assert_reconciled(loop)
    assert loop.counters["shed"] >= len(shed)
    assert loop.counters["done"] == 24 - loop.counters["shed"]
    assert 0.0 < loop.server.ledger.summary()["shed_frac"] < 1.0


def test_expired_requests_shed_at_pop_time():
    """A request whose budget lapsed while queued is shed when its
    group pops, never dispatched."""
    clock = VirtualClock()
    srv = _account_server(clock, wait_budget=0.3)
    loop = ServingLoop(srv, deadline_s=0.25)
    rid = loop.submit(n_images=3)         # partial bucket: waits
    assert loop.pump() == []
    clock.sleep(0.4)                      # past wait budget AND deadline
    assert loop.pump() == []
    assert loop.state_of(rid) is RequestState.SHED
    assert loop.counters["shed_expired"] == 1
    assert "queued" in loop.requests[rid].shed_reason
    _assert_reconciled(loop)


# --------------------------------------------------------------------------
# retry / backoff and terminal failure
# --------------------------------------------------------------------------

def test_transient_failure_retries_with_backoff_then_succeeds():
    clock = VirtualClock()
    plan = FaultPlan.failures(0)
    loop = ServingLoop(_account_server(clock), deadline_s=10.0,
                       fault_plan=plan, seed=1)
    rids = [loop.submit(n_images=4), loop.submit(n_images=4)]
    assert loop.pump() == []              # attempt 0 injected to fail
    assert loop.counters["dispatch_failures"] == 1
    assert loop.counters["retries"] == 1
    assert loop.stats["retry_backlog"] == 1
    t_fail = clock.now
    loop.run_sync(tick_s=0.01)            # ticks reach the backoff due
    assert clock.now >= t_fail + 0.9 * loop.backoff_base_s
    assert all(loop.state_of(r) is RequestState.DONE for r in rids)
    assert all(loop.requests[r].attempts == 2 for r in rids)
    assert [e.kind for e in plan.triggered] == ["fail"]
    _assert_reconciled(loop)


def test_exhausted_retries_fail_terminally():
    clock = VirtualClock()
    loop = ServingLoop(_account_server(clock), deadline_s=None,
                       max_retries=2,
                       fault_plan=FaultPlan.failures(*range(50)))
    rids = [loop.submit(n_images=8) for _ in range(2)]
    loop.run_sync(tick_s=0.01)
    for rid in rids:
        t = loop.requests[rid]
        assert t.state is RequestState.FAILED
        assert "InjectedFault" in t.error
    assert loop.counters["failed"] == 2
    assert loop.server.ledger.failed_images == 16
    _assert_reconciled(loop)


def test_drain_mid_storm_drops_nothing():
    """Shutdown while the queue holds work and every dispatch keeps
    failing: drain still walks each rid to a terminal state."""
    clock = VirtualClock()
    srv = _account_server(clock, buckets=(1,), wait_budget=10.0)
    loop = ServingLoop(srv, deadline_s=None, max_retries=2,
                       fault_plan=FaultPlan.failures(*range(50)))
    rids = [loop.submit(n_images=1) for _ in range(5)]
    loop.pump()                           # first attempts fail -> retries
    assert not loop.all_terminal()
    assert loop.drain() == []
    assert all(loop.state_of(r) is RequestState.FAILED for r in rids)
    assert loop.counters["dispatch_failures"] == 15   # 3 attempts x 5
    _assert_reconciled(loop)


# --------------------------------------------------------------------------
# circuit breaker: the ladder kernel -> account-only, from the server's
# own target
# --------------------------------------------------------------------------

def test_kernel_ladder_is_kernel_then_account_only():
    """No rung between computing and account-only: no plain version
    and no library call for a degraded dispatch."""
    assert KERNEL.ladder() == (KERNEL, ACCOUNT_ONLY)
    assert ACCOUNT_ONLY.ladder() == (ACCOUNT_ONLY,)
    assert KERNEL.clamp(None) is KERNEL
    assert KERNEL.clamp("account-only") is ACCOUNT_ONLY
    assert ACCOUNT_ONLY.clamp(KERNEL) is ACCOUNT_ONLY   # never upgrades
    srv = _compute_server(buckets=(2,))
    with pytest.raises(ValueError, match="runs no pipeline"):
        srv.pipeline(2, ACCOUNT_ONLY)
    assert srv._execute([], 2, target=ACCOUNT_ONLY) is None


def test_breaker_degrades_down_the_ladder_and_ledger_counts_it():
    srv = _compute_server(buckets=(2,), wait_budget=0.0)
    loop = ServingLoop(srv, deadline_s=None,
                       breaker_threshold=1, max_retries=5,
                       fault_plan=FaultPlan.failures(0, 1))
    rid = loop.submit(torch.ones((2, 8, 8, 3)))
    (res,) = loop.run_sync(tick_s=0.01)
    assert loop.state_of(rid) is RequestState.DONE
    # two rungs, so the second failure has nowhere lower to go
    assert loop.breaker.trips == 1
    assert loop.breaker.mode.name == "account-only"
    assert loop.server.ledger.degraded_dispatches == 1
    assert res.logits is None
    assert srv.stats["traces"] == 0       # no pipeline was ever built
    _assert_reconciled(loop)


def test_breaker_ladder_is_capped_at_the_servers_own_target():
    """An account-only server has a one-rung ladder: the breaker can
    never degrade, or recover past the server's target."""
    clock = VirtualClock()
    loop = ServingLoop(_account_server(clock), deadline_s=None,
                       breaker_threshold=1, max_retries=5,
                       fault_plan=FaultPlan.failures(0, 1))
    assert [t.name for t in loop.breaker.ladder] == ["account-only"]
    rid = loop.submit(n_images=8)
    loop.run_sync(tick_s=0.01)
    assert loop.state_of(rid) is RequestState.DONE
    assert loop.breaker.trips == 0
    assert loop.breaker.mode.name == "account-only"
    assert loop.server.ledger.degraded_dispatches == 0
    _assert_reconciled(loop)


def test_breaker_steps_back_up_after_cooldown():
    br = CircuitBreaker(threshold=2, cooldown_s=1.0)
    assert br.mode.name == "kernel"       # default ladder ceiling
    br.record_failure(0.0)
    assert br.level == 0                  # below threshold
    br.record_failure(0.0)
    assert (br.level, br.mode.name, br.trips) == (1, "account-only", 1)
    br.record_failure(0.0)
    br.record_failure(0.0)                # the bottom rung: no lower
    assert (br.level, br.trips) == (1, 1)
    br.record_success(0.5)                # inside cooldown: stays
    assert br.level == 1
    br.record_success(1.6)                # cooled down: half-open re-probe
    assert (br.level, br.mode.name) == (0, "kernel")


def test_breaker_routes_around_a_poisoned_kernel_path():
    """The kernel pipeline raises; the breaker degrades to
    account-only, which plans and charges but computes nothing: the
    request ends DONE without logits, and nothing ran the plain
    version in the kernel's place."""
    params = _tiny_params()
    graph = vgg_graph(params)
    calls = []

    def forward(p, imgs, target):
        calls.append(target.name)
        raise RuntimeError("kernel path poisoned")

    srv = ImageServer(params, 8, 8, graph=graph, forward=forward,
                      buckets=(2,), wait_budget=0.0, device="cpu")
    loop = ServingLoop(srv, deadline_s=None, breaker_threshold=1,
                       max_retries=3, backoff_base_s=0.01)
    imgs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, 8, 3)).astype(np.float32))
    before = torch_kernel.conv_lb.launches
    rid = loop.submit(imgs)
    (res,) = loop.run_sync(tick_s=0.005)
    assert loop.state_of(rid) is RequestState.DONE
    assert loop.breaker.mode.name == "account-only"
    assert res.logits is None
    assert srv.ledger.degraded_dispatches == 1
    assert calls == ["kernel"]            # the degraded retry ran none
    assert torch_kernel.conv_lb.launches == before
    assert res.charge.images == 2         # charged all the same


# --------------------------------------------------------------------------
# clock skew
# --------------------------------------------------------------------------

def test_clock_skew_never_charges_negative_latency():
    clock = VirtualClock(start=10.0)
    plan = FaultPlan([FaultEvent(at=0, kind="skew", value=-5.0)],
                     service_s=0.01)
    loop = ServingLoop(_account_server(clock), deadline_s=None,
                       fault_plan=plan)
    loop.submit(n_images=8)
    (res,) = loop.run_sync(tick_s=0.01)
    assert clock.now < 10.0               # the skew really fired
    assert res.latency_s >= 0.0
    assert res.charge.latency_s >= 0.0
    _assert_reconciled(loop)


# --------------------------------------------------------------------------
# chaos suite: drop-free invariant under seeded random schedules
# --------------------------------------------------------------------------

def _episode(seed: int, loop_cls, server, plan_cls, clock):
    """One seeded episode, drawn the reference's way: random arrivals,
    sizes and pump cadence, ``FaultPlan.random(seed)`` faults, then run
    to quiescence.  ``loop_cls``/``plan_cls`` pick the package."""
    rng = random.Random(seed)
    loop = loop_cls(
        server,
        deadline_s=rng.choice([0.15, 0.5, None]),
        max_retries=rng.randint(1, 3),
        fault_plan=plan_cls.random(seed, service_s=0.02),
        service_estimate_s=rng.choice([0.0, 0.02]),
        seed=seed)
    for _ in range(rng.randint(5, 15)):
        clock.sleep(rng.uniform(0.0, 0.08))
        loop.submit(n_images=rng.randint(1, 4))
        if rng.random() < 0.5:
            loop.pump()
    loop.run_sync(tick_s=0.01)
    return loop


def _run_chaos(seed: int) -> ServingLoop:
    clock = VirtualClock()
    loop = _episode(seed, ServingLoop,
                    _account_server(clock, wait_budget=0.05), FaultPlan,
                    clock)
    _assert_reconciled(loop)
    s = loop.server.ledger.summary()
    if s.get("measured_latencies"):
        assert s["p50_latency_s"] >= 0.0
        assert s["p99_latency_s"] >= s["p50_latency_s"]
    return loop


def test_chaos_known_seeds_cover_all_fault_kinds():
    kinds = set()
    for seed in (0, 3, 7, 11, 23):
        loop = _run_chaos(seed)
        kinds |= {e.kind for e in loop.fault_plan.triggered}
    assert kinds >= {"fail", "delay"}


@settings(max_examples=12, deadline=None)
@given(st.integers(min_value=0, max_value=99_999))
def test_chaos_drop_free_invariant_property(seed):
    _run_chaos(seed)


def test_chaos_replay_is_deterministic():
    a, b = _run_chaos(42), _run_chaos(42)
    assert a.counters == b.counters
    assert ([t.state for t in a.requests.values()]
            == [t.state for t in b.requests.values()])
    assert ([(e.at, e.kind) for e in a.fault_plan.triggered]
            == [(e.at, e.kind) for e in b.fault_plan.triggered])


# --------------------------------------------------------------------------
# parity with the reference loop (account-only, virtual clock)
# --------------------------------------------------------------------------

def _terminal(loop) -> dict:
    return {rid: (t.state.value, t.attempts, t.shed_reason, t.error,
                  t.arrival, t.terminal_at)
            for rid, t in loop.requests.items()}


def _counts(loop) -> dict:
    return {**loop.counters, "trips": loop.breaker.trips,
            "level": loop.breaker.level,
            "triggered": [(e.at, e.kind, e.value)
                          for e in loop.fault_plan.triggered]}


@pytest.mark.parametrize("seed", [0, 1, 3, 7, 11, 23, 42, 1234])
def test_loop_equals_reference_loop_account_only(seed, monkeypatch):
    """The same seeded episode through both loops: every rid's terminal
    state, attempts, reasons and times, the counters, trips and fired
    faults, and the ledger summaries equal, exactly (both libraries'
    fallback tallies emptied for the comparison)."""
    monkeypatch.setattr(jax_conv_ops, "FALLBACK_COUNTS", {})
    monkeypatch.setattr(torch_conv_ops, "FALLBACK_COUNTS", {})
    assert ([dataclasses.astuple(e) for e in FaultPlan.random(seed).events]
            == [dataclasses.astuple(e)
                for e in JaxFaultPlan.random(seed).events])
    clock, jclock = VirtualClock(), JaxVirtualClock()
    ours = _episode(seed, ServingLoop,
                    _account_server(clock, wait_budget=0.05), FaultPlan,
                    clock)
    ref = _episode(seed, JaxServingLoop,
                   JaxImageServer(_jax_tiny_params(), 8, 8, compute=False,
                                  clock=jclock, wait_budget=0.05),
                   JaxFaultPlan, jclock)
    assert _terminal(ours) == _terminal(ref)
    assert _counts(ours) == _counts(ref)
    assert clock.now == jclock.now
    got, want = ours.server.ledger.summary(), ref.server.ledger.summary()
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float) and math.isnan(want[k]):
            assert math.isnan(got[k]), k
        else:
            assert got[k] == want[k], k
    assert ([dataclasses.asdict(c) for c in ours.server.ledger.charges]
            == [dataclasses.asdict(c) for c in ref.server.ledger.charges])


@pytest.mark.parametrize("spec", ["fail@1,fail@2,delay@5:0.02",
                                  "fail@0,skew@2:-0.2,service:0.03"])
def test_breaker_and_faults_equal_reference_account_only(spec):
    """A parsed plan on a fixed trace at a low breaker threshold: both
    loops fail, retry and (on the reference's one-rung account-only
    ladder and the port's alike) never trip, identically."""
    out = []
    for loop_cls, plan_cls, clock in (
            (ServingLoop, FaultPlan, VirtualClock()),
            (JaxServingLoop, JaxFaultPlan, JaxVirtualClock())):
        srv = (_account_server(clock) if loop_cls is ServingLoop else
               JaxImageServer(_jax_tiny_params(), 8, 8, compute=False,
                              clock=clock, wait_budget=0.01))
        loop = loop_cls(srv, deadline_s=0.5, breaker_threshold=2,
                        fault_plan=plan_cls.parse(spec), seed=3)
        for n in (4, 4, 4, 4, 2, 2, 1, 1):
            loop.submit(n_images=n)
            loop.pump()
        loop.run_sync(tick_s=0.005)
        out.append((_terminal(loop), _counts(loop), clock.now,
                    loop.server.ledger.summary()["goodput"]))
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# run_async: in-flight overlap, one launching thread
# --------------------------------------------------------------------------

def test_run_async_overlaps_up_to_max_inflight():
    srv = ImageServer(_tiny_params(), 8, 8, target="account-only",
                      device="cpu", buckets=(1,), wait_budget=0.0)
    loop = ServingLoop(srv, deadline_s=None, max_inflight=2,
                       fault_plan=FaultPlan(service_s=0.05))
    for _ in range(4):
        loop.submit(n_images=1)
    results = asyncio.run(loop.run_async())
    assert len(results) == 4
    assert loop.counters["peak_inflight"] == 2
    _assert_reconciled(loop)


def test_run_async_enqueues_from_one_thread_at_a_time():
    """Stress: 8 attempts in flight (more than the host's threads need)
    and a short switch interval; the forward, which stands where the
    kernels enqueue, is never entered by two threads at once, while
    the attempts overlap and every logits tensor is the plain
    forward's."""
    params = _tiny_params()
    graph = vgg_graph(params)
    inside, most = [0], [0]
    guard = threading.Lock()

    def forward(p, imgs, target):
        with guard:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        try:
            time.sleep(0.002)             # hold the enqueue open
            return graph_logits(graph, p, imgs)
        finally:
            with guard:
                inside[0] -= 1

    srv = ImageServer(params, 8, 8, graph=graph, forward=forward,
                      buckets=(1, 2), wait_budget=0.0, device="cpu")
    loop = ServingLoop(srv, deadline_s=None, max_inflight=8,
                       fault_plan=FaultPlan(service_s=0.01))
    rng = np.random.default_rng(5)
    imgs = [torch.from_numpy(rng.standard_normal((1 + i % 2, 8, 8, 3))
                             .astype(np.float32)) for i in range(24)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for x in imgs:
            loop.submit(x)
        results = asyncio.run(asyncio.wait_for(loop.run_async(), 60))
    finally:
        sys.setswitchinterval(switch)
    assert most[0] == 1
    assert loop.counters["peak_inflight"] > 1
    assert sorted(r.rid for r in results) == list(range(24))
    for r in results:
        torch.testing.assert_close(r.logits,
                                   graph_logits(graph, params, imgs[r.rid]))
    _assert_reconciled(loop)


# --------------------------------------------------------------------------
# fault-injection plumbing
# --------------------------------------------------------------------------

def test_virtual_clock_sleep_clamps_and_jump_skews():
    c = VirtualClock(start=1.0)
    c.sleep(0.5)
    c.sleep(-3.0)                         # sleeps never rewind
    assert c() == 1.5
    c.jump(-0.7)                          # skews may
    assert c() == pytest.approx(0.8)


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultEvent(at=0, kind="explode")


def test_fault_plan_fail_is_fail_fast_and_logged():
    plan = FaultPlan.failures(1, service_s=0.02)
    assert plan.before_dispatch(0, 8) == pytest.approx(0.02)
    with pytest.raises(InjectedFault):
        plan.before_dispatch(1, 8)
    assert [e.at for e in plan.triggered] == [1]


def test_fault_plan_bucket_restriction():
    plan = FaultPlan([FaultEvent(at=0, kind="fail", bucket=4)])
    assert plan.before_dispatch(0, 8) == 0.0     # other bucket: no-op
    with pytest.raises(InjectedFault):
        plan.before_dispatch(0, 4)


@pytest.mark.parametrize("seed", [0, 9, 10, 77, 99_999])
def test_fault_plan_random_is_seed_deterministic(seed):
    """One seed, one schedule: the port's and the reference's draw the
    same events (both from ``random.Random`` in the same order)."""
    a, b = FaultPlan.random(seed), FaultPlan.random(seed)
    assert a.events == b.events
    assert FaultPlan.random(seed + 1).events != a.events
    kw = dict(n_dispatches=64, p_fail=0.3, max_delay_s=0.5,
              service_s=0.05)
    for ours, ref in ((a, JaxFaultPlan.random(seed)),
                      (FaultPlan.random(seed, **kw),
                       JaxFaultPlan.random(seed, **kw))):
        assert ([dataclasses.astuple(e) for e in ours.events]
                == [dataclasses.astuple(e) for e in ref.events])
        assert (ours.service_s, ours.name) == (ref.service_s, ref.name)


def test_fault_plan_parse_spec_and_random():
    plan = FaultPlan.parse("fail@1,delay@3:0.05,skew@6:-0.2,service:0.01")
    assert [(e.at, e.kind, e.value) for e in plan.events] == [
        (1, "fail", 0.0), (3, "delay", 0.05), (6, "skew", -0.2)]
    assert plan.service_s == pytest.approx(0.01)
    assert FaultPlan.parse("random:7").events \
        == FaultPlan.random(7).events
    with pytest.raises(ValueError):
        FaultPlan.parse("fail")           # missing @AT
    with pytest.raises(ValueError):
        FaultPlan.parse("explode@1")      # unknown kind


# --------------------------------------------------------------------------
# acceptance: the reference benchmark's bursty trace through the port
# --------------------------------------------------------------------------

#: ``benchmarks/serve_bench.py`` ``bench_serve_loop_bursty``: 6 steady
#: bursts of 16 images 0.25 s apart, then a storm of 24 requests (64
#: images) against a 0.3 s budget and 50 ms of service a dispatch
BURSTS = ([(t * 0.25, (4, 2, 1, 1, 4, 2, 1, 1)) for t in range(6)]
          + [(6 * 0.25, (4, 4, 2, 2, 4, 1, 1, 2, 4, 2, 4, 2,
                         4, 4, 2, 2, 4, 1, 1, 2, 4, 2, 4, 2))])


def _port_bursty_rows():
    params = init_vgg(torch.Generator().manual_seed(0), n_classes=10,
                      width_mult=1.0, device="cpu")
    clock = VirtualClock()
    server = ImageServer(params, 224, 224, target="account-only",
                         device="cpu", clock=clock, wait_budget=0.02)
    loop = ServingLoop(server, deadline_s=0.30,
                       fault_plan=FaultPlan(service_s=0.05),
                       service_estimate_s=0.05, seed=0)
    for at, sizes in BURSTS:
        if clock.now < at:
            clock.sleep(at - clock.now)
        for n in sizes:
            loop.submit(n_images=n)
        loop.pump()
    loop.run_sync(tick_s=0.01)
    horizon = max(clock.now, 1e-9)
    s = server.ledger.summary()
    assert loop.all_terminal()
    _assert_reconciled(loop)
    return [
        ("serve_loop/vgg16_bursty/serve_shed_frac", None,
         round(s["shed_frac"], 3)),
        ("serve_loop/vgg16_bursty/serve_goodput_rps", None,
         round(s["served_requests"] / horizon, 1)),
        ("serve_loop/vgg16_bursty/serve_p99_x_budget", None,
         round(s["p99_latency_s"] / 0.30, 3)),
        ("serve_loop/vgg16_bursty/vs_bound_x", None,
         round(s["vs_bound_x"], 3)),
        ("serve_loop/vgg16_bursty/dispatches", None, s["dispatches"]),
    ]


def test_bursty_trace_sheds_bounded_and_stays_within_bound():
    """The bursty VGG16/224 trace at full width: the port's rows equal
    the reference benchmark's, and hold the reference test's bounds
    (the storm's tail sheds, served requests within 1.25x Eq. (15),
    p99 within the budget)."""
    sb = _load(REPO / "benchmarks" / "serve_bench.py")
    ours = _port_bursty_rows()
    assert ours == sb.bench_serve_loop_bursty()
    rows = {name: val for name, _, val in ours}
    shed = rows["serve_loop/vgg16_bursty/serve_shed_frac"]
    assert 0.0 < shed <= 0.35
    assert rows["serve_loop/vgg16_bursty/serve_goodput_rps"] > 0
    assert rows["serve_loop/vgg16_bursty/serve_p99_x_budget"] <= 1.0
    assert rows["serve_loop/vgg16_bursty/vs_bound_x"] <= 1.25
    assert all(math.isfinite(v) for v in rows.values())


# --------------------------------------------------------------------------
# compute: the port's loop at the kernel target against the reference's
# at lax, on the same weights
# --------------------------------------------------------------------------

def _numpy_tree(params):
    return {"convs": [{k: np.asarray(v) for k, v in p.items()}
                      for p in params["convs"]],
            "head": np.asarray(params["head"])}


@pytest.mark.parametrize("spec", ["", "fail@1,delay@2:0.03,fail@4"])
def test_compute_loop_equals_reference_lax_loop(spec):
    ref_params = jax_init_vgg(jax.random.PRNGKey(3), n_classes=4,
                              width_mult=0.05)
    params = params_from_numpy(_numpy_tree(ref_params), device="cpu")
    rng = np.random.default_rng(3)
    payloads = [rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
                for n in (1, 3, 2, 4, 1, 2)]
    got = []
    for pkg in ("ours", "ref"):
        clock = VirtualClock() if pkg == "ours" else JaxVirtualClock()
        if pkg == "ours":
            srv = ImageServer(params, 8, 8, buckets=(1, 2, 4),
                              device="cpu", clock=clock, wait_budget=0.01)
            loop = ServingLoop(srv, deadline_s=1.0,
                               fault_plan=FaultPlan.parse(spec), seed=2)
        else:
            srv = JaxImageServer(ref_params, 8, 8, buckets=(1, 2, 4),
                                 target="lax", clock=clock,
                                 wait_budget=0.01)
            loop = JaxServingLoop(srv, deadline_s=1.0,
                                  fault_plan=JaxFaultPlan.parse(spec),
                                  seed=2)
        results = []
        for x in payloads:
            loop.submit(x)
            results += loop.pump()
        results += loop.run_sync(tick_s=0.005)
        got.append((_terminal(loop), sorted(results,
                                            key=lambda r: r.rid)))
    (ours_t, ours), (ref_t, ref) = got
    assert ours_t == ref_t
    assert [r.rid for r in ours] == list(range(len(payloads)))
    assert [r.rid for r in ours] == [r.rid for r in ref]
    for o, r in zip(ours, ref):
        rl = np.asarray(r.logits)
        assert tuple(o.logits.shape) == rl.shape
        err = np.abs(o.logits.numpy() - rl).max()
        assert err <= 1e-5 * np.abs(rl).max(), (o.rid, err)
        assert dataclasses.asdict(o.charge) == dataclasses.asdict(r.charge)


# --------------------------------------------------------------------------
# CLI smoke: --deadline / --fault-plan, and lint rule L005
# --------------------------------------------------------------------------

def test_launch_serve_images_computes_through_the_loop(capsys):
    serve_images.main(["--device", "cpu", "--requests", "3",
                       "--image", "8", "--width-mult", "0.05",
                       "--deadline", "5.0", "--fault-plan", "fail@0"])
    out = capsys.readouterr().out
    assert "loop:" in out and "health:" in out
    assert "'retries': 1" in out          # the injected failure retried


def test_launch_serve_images_fault_loop_smoke(capsys):
    serve_images.main(["--account-only", "--device", "cpu",
                       "--width-mult", "1.0", "--image", "224",
                       "--requests", "6", "--deadline", "0.25",
                       "--fault-plan", "fail@1,service:0.01"])
    out = capsys.readouterr().out
    assert "loop:" in out and "health:" in out
    assert "'dispatch_failures': 1" in out


@pytest.mark.parametrize("name", ["faults.py", "ledger.py", "loop.py",
                                  "server.py", "bucketing.py"])
def test_serve_takes_its_clock_and_sleep_by_injection(name):
    """The reference's lint rule L005 over the port's ``serve/``: no
    bare clock or sleep call, only parameter defaults."""
    path = REPO / "src" / "repro_torch" / "serve" / name
    assert [f for f in lint_file(path) if f.rule == "L005"] == []
