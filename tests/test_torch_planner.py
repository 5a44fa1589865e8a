"""The port's planner and traffic accountant equal the reference's
exactly: every plan handle the serve ledger charges (VGG16/224 and
ResNet-20/32 at the served buckets, 1 MiB budget) has the same blocks,
padding, traffic and Eq. (15) bound, word for word — and so do the
plans at the reference planner's default budget."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import lower_bound as jax_lb
from repro.core.layer import ConvLayer as JaxConvLayer
from repro.core.vgg import vgg16_conv_layers
from repro.kernels.conv_lb.ops import conv_lb_traffic as jax_traffic
from repro.kernels.conv_lb.ops import conv_lb_traffic_bytes as jax_bytes
from repro.models.cnn import init_vgg as jax_init_vgg
from repro.models.cnn import resnet_graph as jax_resnet_graph
from repro.models.cnn import vgg_graph as jax_vgg_graph
from repro.models.graph import graph_plan_handles as jax_handles
from repro_torch.analysis.plan_check import (PlanLegalityError,
                                             check_conv_plan, errors)
from repro_torch.core import lower_bound as lb
from repro_torch.core.layer import ConvLayer
from repro_torch.kernels.conv_lb.ops import (conv_lb_traffic,
                                             conv_lb_traffic_bytes,
                                             plan_conv)
from repro_torch.models.cnn import resnet_graph, vgg_graph
from repro_torch.models.graph import graph_plan_handles

MIB = 1 << 20
_PLAN_FIELDS = ("ho", "wo", "ho_pad", "wo_pad", "hp_pad", "wp_pad",
                "ci_pad", "co_pad", "stride", "dilation", "hk", "wk",
                "pool", "lhs_dilation", "h", "w", "ci", "co", "py", "px",
                "residual")


def _graphs(model):
    if model == "vgg":
        params = jax_init_vgg(jax.random.PRNGKey(0))
        ref = jax_vgg_graph(params)
        shapes = [{"w": p["w"]} for p in params["convs"]]
        return ref, vgg_graph({"convs": shapes}), 224
    return jax_resnet_graph(), resnet_graph(), 32


@pytest.fixture(scope="module")
def graphs():
    return {m: _graphs(m) for m in ("vgg", "resnet")}


@pytest.mark.parametrize("budget", [MIB, None])
@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("model", ["vgg", "resnet"])
def test_plan_handles_equal_reference(graphs, model, batch, budget):
    ref_graph, graph, size = graphs[model]
    ref = jax_handles(ref_graph, size, size, batch=batch,
                      vmem_budget=budget, verify=True)
    got = graph_plan_handles(graph, size, size, batch=batch,
                             vmem_budget=budget, verify=True)
    assert len(got) == len(ref) == len(graph.nodes)
    for (layer, plan), (rlayer, rplan) in zip(got, ref):
        assert dataclasses.asdict(layer) == dataclasses.asdict(rlayer)
        assert dataclasses.asdict(plan.blocks) == \
            dataclasses.asdict(rplan.blocks)
        for f in _PLAN_FIELDS:
            assert getattr(plan, f) == getattr(rplan, f), (layer.name, f)
        t, rt = plan.traffic(batch), rplan.traffic(batch)
        assert (t.reads_in, t.reads_w, t.reads_out, t.writes_out) == \
            (rt.reads_in, rt.reads_w, rt.reads_out, rt.writes_out)
        assert plan.bound_words(layer) == rplan.bound_words(rlayer)
        assert plan.footprint_elems() == rplan.footprint_elems()


@pytest.mark.parametrize("autotune", [True, False])
@pytest.mark.parametrize("budget", [MIB, 64 * 1024])
def test_conv_lb_traffic_equals_reference(autotune, budget):
    for layer in vgg16_conv_layers(batch=3):
        kw = dict(stride=layer.stride, padding=layer.pad,
                  vmem_budget=budget, autotune=autotune)
        args = (layer.batch, layer.hi, layer.wi, layer.ci, layer.co,
                layer.hk, layer.wk)
        t, _ = conv_lb_traffic(*args, **kw)
        rt, _ = jax_traffic(*args, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(rt), layer.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traffic_bytes_take_the_word_size_of_the_dtype(dtype):
    args = (4, 56, 56, 128, 256, 3, 3)
    kw = dict(padding=1, pool=2, vmem_budget=MIB)
    got = conv_lb_traffic_bytes(*args, dtype=getattr(torch, dtype), **kw)
    assert got == jax_bytes(*args, dtype=getattr(jnp, dtype), **kw)
    assert conv_lb_traffic_bytes(*args, **kw) == jax_bytes(*args, **kw)


@pytest.mark.parametrize("s", [1 << 10, 1 << 16, 1 << 20, 1 << 26])
def test_lower_bound_equals_reference(s):
    for rl in vgg16_conv_layers(batch=2) + [
            JaxConvLayer("proj", 2, 16, 32, 32, 32, 1, 1, 2, 0),
            JaxConvLayer("down", 2, 16, 32, 32, 32, 3, 3, 2, 1)]:
        layer = ConvLayer(**dataclasses.asdict(rl))
        assert lb.q_dram_practical(layer, s) == \
            jax_lb.q_dram_practical(rl, s)
        assert lb.q_dram_serving(layer, s, requests=7) == \
            jax_lb.q_dram_serving(rl, s, requests=7)
        assert lb.optimal_block(s, layer.reuse_r) == \
            lb.OptimalTiles(**dataclasses.asdict(
                jax_lb.optimal_block(s, rl.reuse_r)))
        assert lb.fold_u(s // 64, 8, layer.ho, layer.wo) == \
            jax_lb.fold_u(s // 64, 8, rl.ho, rl.wo)


def test_plan_check_flags_a_broken_plan():
    plan = plan_conv(28, 28, 64, 64, 3, 3, batch=2, padding=(1, 1),
                     pool=2, vmem_budget=MIB)
    assert not errors(check_conv_plan(plan, vmem_budget=MIB))
    bad = dataclasses.replace(
        plan, blocks=dataclasses.replace(plan.blocks, halo_y=1, y=3))
    rules = {d.rule for d in errors(check_conv_plan(bad,
                                                    vmem_budget=MIB))}
    assert {"conv.halo", "conv.pool", "conv.grid"} <= rules
    with pytest.raises(PlanLegalityError):
        raise PlanLegalityError(check_conv_plan(bad, vmem_budget=MIB))


def test_plan_conv_rejects_unpoolable_plane():
    with pytest.raises(ValueError, match="pool"):
        plan_conv(15, 15, 4, 4, 3, 3, padding=(1, 1), pool=2)
