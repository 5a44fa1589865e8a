"""The port's training-step accounting equals the reference's exactly:
the dgrad and wgrad plans of every layer, the training-plan triple and
its traffic and bound, the per-pass Eq. (15) bounds, the audit of the
training handles and the training-step report — VGG16/224 and
ResNet-20/32 at batch 8, at the reference planner's default budget
and at the paper's 1 MiB."""

import dataclasses

import jax
import pytest

from repro.analysis.plan_check import audit_handles as jax_audit
from repro.analysis.plan_check import check_wgrad_plan as jax_check_wgrad
from repro.analysis.plan_check import \
    symbolic_wgrad_traffic as jax_symbolic_wgrad
from repro.core import lower_bound as jax_lb
from repro.core.layer import ConvLayer as JaxConvLayer
from repro.kernels.conv_lb import ops as jax_ops
from repro.models.cnn import init_vgg as jax_init_vgg
from repro.models.cnn import resnet_graph as jax_resnet_graph
from repro.models.cnn import vgg_graph as jax_vgg_graph
from repro.models.cnn import \
    vgg_training_step_report as jax_vgg_training_step_report
from repro.models.graph import graph_plan_handles as jax_handles
from repro.models.graph import \
    graph_training_step_report as jax_training_report
from repro_torch.analysis.plan_check import (audit_handles,
                                             check_wgrad_plan, errors,
                                             symbolic_wgrad_traffic)
from repro_torch.core import lower_bound as lb
from repro_torch.core.layer import ConvLayer
from repro_torch.kernels.conv_lb import ops
from repro_torch.models.cnn import (resnet_graph, vgg_graph,
                                    vgg_training_step_report)
from repro_torch.models.graph import (graph_plan_handles,
                                      graph_training_step_report)

MIB = 1 << 20
BATCH = 8
_PLAN_FIELDS = ("ho", "wo", "ho_pad", "wo_pad", "hp_pad", "wp_pad",
                "ci_pad", "co_pad", "stride", "dilation", "hk", "wk",
                "pool", "lhs_dilation", "h", "w", "ci", "co", "py", "px",
                "residual")


def _graphs(model):
    if model == "vgg":
        params = jax_init_vgg(jax.random.PRNGKey(0))
        shapes = {"convs": [{"w": p["w"]} for p in params["convs"]]}
        return jax_vgg_graph(params), vgg_graph(shapes), 224, params
    return jax_resnet_graph(), resnet_graph(), 32, None


@pytest.fixture(scope="module")
def graphs():
    return {m: _graphs(m) for m in ("vgg", "resnet")}


def _traffic(t):
    return (t.reads_in, t.reads_w, t.reads_out, t.writes_out)


def _same_conv_plan(plan, rplan):
    assert dataclasses.asdict(plan.blocks) == \
        dataclasses.asdict(rplan.blocks)
    for f in _PLAN_FIELDS:
        assert getattr(plan, f) == getattr(rplan, f), f
    assert _traffic(plan.traffic(BATCH)) == _traffic(rplan.traffic(BATCH))
    assert plan.footprint_elems() == rplan.footprint_elems()


@pytest.mark.parametrize("budget", [None, MIB])
@pytest.mark.parametrize("model", ["vgg", "resnet"])
def test_training_handles_equal_reference(graphs, model, budget):
    ref_graph, graph, size, _ = graphs[model]
    ref = jax_handles(ref_graph, size, size, batch=BATCH,
                      vmem_budget=budget, training=True, verify=True)
    got = graph_plan_handles(graph, size, size, batch=BATCH,
                             vmem_budget=budget, training=True,
                             verify=True)
    assert len(got) == len(ref) == len(graph.nodes)
    for (layer, tp), (rlayer, rtp) in zip(got, ref):
        assert dataclasses.asdict(layer) == dataclasses.asdict(rlayer)
        _same_conv_plan(tp.fwd, rtp.fwd)
        _same_conv_plan(tp.dgrad, rtp.dgrad)
        assert dataclasses.asdict(tp.wgrad) == dataclasses.asdict(rtp.wgrad)
        assert (tp.wgrad.lag, tp.wgrad.grid, tp.wgrad.ho_pad) == \
            (rtp.wgrad.lag, rtp.wgrad.grid, rtp.wgrad.ho_pad)
        assert tp.wgrad.footprint_elems() == rtp.wgrad.footprint_elems()
        assert tp.dgrad_kernel == rtp.dgrad_kernel
        assert ops.dgrad_rides_kernel(tp.fwd) == \
            jax_ops.dgrad_rides_kernel(rtp.fwd)
        t, rt = tp.traffic(BATCH), rtp.traffic(BATCH)
        for p in ("fwd", "dgrad", "wgrad"):
            assert _traffic(getattr(t, p)) == _traffic(getattr(rt, p)), p
        assert (t.total, t.bwd_share, t.total_bytes()) == \
            (rt.total, rt.bwd_share, rt.total_bytes())
        assert tp.traffic_bytes(BATCH) == rtp.traffic_bytes(BATCH)
        assert tp.bound_words(layer) == rtp.bound_words(rlayer)


@pytest.mark.parametrize("budget", [None, MIB])
@pytest.mark.parametrize("model", ["vgg", "resnet"])
def test_plan_functions_equal_reference_off_one_handle(graphs, model,
                                                       budget):
    """plan_conv_dgrad / plan_conv_wgrad / plan_conv_training called
    directly (not through the graph), autotuned and not."""
    ref_graph, graph, size, _ = graphs[model]
    ref = jax_handles(ref_graph, size, size, batch=BATCH,
                      vmem_budget=budget)
    got = graph_plan_handles(graph, size, size, batch=BATCH,
                             vmem_budget=budget)
    for (_, plan), (_, rplan) in zip(got, ref):
        for autotune in (True, False):
            kw = dict(vmem_budget=budget, autotune=autotune)
            _same_conv_plan(
                ops.plan_conv_dgrad(plan, batch=BATCH, **kw),
                jax_ops.plan_conv_dgrad(rplan, batch=BATCH, **kw))
            assert dataclasses.asdict(ops.plan_conv_wgrad(plan, **kw)) == \
                dataclasses.asdict(jax_ops.plan_conv_wgrad(rplan, **kw))
        for groups in (1, 2):
            tp = ops.plan_conv_training(plan, batch=BATCH, groups=groups,
                                        vmem_budget=budget)
            rtp = jax_ops.plan_conv_training(rplan, batch=BATCH,
                                             groups=groups,
                                             vmem_budget=budget)
            assert tp.dgrad_kernel == rtp.dgrad_kernel


@pytest.mark.parametrize("s", [1 << 10, 1 << 16, 1 << 20, 1 << 26])
def test_training_bounds_equal_reference(graphs, s):
    layers = [rl for rl, _ in jax_handles(graphs["resnet"][0], 32, 32,
                                          batch=BATCH)]
    layers += [rl for rl, _ in jax_handles(graphs["vgg"][0], 224, 224,
                                           batch=BATCH)]
    layers.append(JaxConvLayer("proj", 2, 16, 32, 32, 32, 1, 1, 2, 0))
    for rl in layers:
        layer = ConvLayer(**dataclasses.asdict(rl))
        assert lb.q_dram_dgrad(layer, s) == jax_lb.q_dram_dgrad(rl, s)
        assert lb.q_dram_wgrad(layer, s) == jax_lb.q_dram_wgrad(rl, s)
        for bwd in (True, False):
            assert lb.q_dram_training(layer, s, bwd=bwd) == \
                jax_lb.q_dram_training(rl, s, bwd=bwd)


@pytest.mark.parametrize("budget", [None, MIB])
@pytest.mark.parametrize("model", ["vgg", "resnet"])
def test_training_audit_equals_reference(graphs, model, budget):
    ref_graph, graph, size, _ = graphs[model]
    kw = dict(batch=BATCH, vmem_budget=budget, training=True)
    ref = jax_audit(jax_handles(ref_graph, size, size, **kw),
                    batch=BATCH, vmem_budget=budget)
    got = audit_handles(graph_plan_handles(graph, size, size, **kw),
                        batch=BATCH, vmem_budget=budget)
    assert got.ok and ref.ok
    assert len(got.entries) == len(ref.entries) == 3 * len(graph.nodes)
    for e, r in zip(got.entries, ref.entries):
        assert (e.name, e.legal, e.traffic_ok, e.bound_ok, e.words,
                e.bound) == (r.name, r.legal, r.traffic_ok, r.bound_ok,
                             r.words, r.bound)
        assert [d.rule for d in errors(e.diagnostics)] == \
            [d.rule for d in r.diagnostics if d.severity == "error"]


def test_wgrad_plan_check_and_symbolic_traffic_equal_reference(graphs):
    ref_graph, graph, size, _ = graphs["resnet"]
    ref = jax_handles(ref_graph, size, size, batch=BATCH,
                      vmem_budget=MIB, training=True)
    got = graph_plan_handles(graph, size, size, batch=BATCH,
                             vmem_budget=MIB, training=True)
    for (_, tp), (_, rtp) in zip(got, ref):
        assert _traffic(symbolic_wgrad_traffic(tp.wgrad, BATCH)) == \
            _traffic(jax_symbolic_wgrad(rtp.wgrad, BATCH))
        # a broken plan: strip past the plane, lag that cannot carry,
        # and a budget nothing fits
        for bad in (dataclasses.replace(tp.wgrad, strip=tp.wgrad.ho + 1),
                    dataclasses.replace(tp.wgrad, ekh=tp.wgrad.ekh + 40)):
            rbad = dataclasses.replace(
                rtp.wgrad, strip=bad.strip, ekh=bad.ekh)
            for budget in (MIB, 64):
                assert [d.rule for d in errors(check_wgrad_plan(
                    bad, vmem_budget=budget))] == \
                    [d.rule for d in jax_check_wgrad(
                        rbad, vmem_budget=budget)
                     if d.severity == "error"]


@pytest.mark.parametrize("budget", [None, MIB])
@pytest.mark.parametrize("model", ["vgg", "resnet"])
def test_training_step_report_equals_reference(graphs, model, budget):
    ref_graph, graph, size, jparams = graphs[model]
    kw = dict(batch=BATCH, vmem_budget=budget)
    got = graph_training_step_report(graph, size, size, **kw)
    assert got == jax_training_report(ref_graph, size, size, **kw)
    if model == "vgg":
        shapes = {"convs": [{"w": p["w"]} for p in jparams["convs"]]}
        assert vgg_training_step_report(shapes, size, size, **kw) == \
            jax_vgg_training_step_report(jparams, size, size, **kw) == got
