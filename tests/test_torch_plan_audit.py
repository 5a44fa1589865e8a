"""The port's plan tools against the reference's, and its Hopper
(``sm90``) legality profile.

  * ``audit_graph`` at ``interpret`` equals the reference's acceptance
    audits (``tests/test_plan_check.py:38-62``) at the paper's 1 MiB:
    VGG16/224 39/39 at batch 8, ResNet-20/32 63 training and 21
    forward-only, every count and the whole report (its header too)
    byte for byte.
  * ``ConvPlan.compact_geometry`` / ``training_traffic`` equal the
    reference's exactly over a sweep of plain and lhs-dilated plans;
    ``explain``'s lines equal the reference's except the ``verifier``
    line, where the reference also lists its ``mosaic.*`` (TPU
    alignment) warnings, which the port does not check for conv plans:
    the port's line is the reference's findings without them.
  * The VGG helpers (``vgg_conv_geometry`` with ``strict``,
    ``vgg_conv_layers_for``, ``vgg_plan_handles``) equal the
    reference's; ``vgg_forward`` / ``resnet_forward`` on CPU tensors
    match the reference's ``target="lax"`` forward at a small width
    (f32; max |err| <= 1e-4 * max |ref|: the same sums in another
    order).
  * ``sm90`` holds on every plan of both nets, f32 and bf16, batches
    1-8, training (and the ResNet stem at batch 65536, whose im2col
    staging grid once overflowed on the card); each ``sm90.*`` rule
    fires on a broken plan; the launchers' fit predicates and the
    checker agree on a seeded sweep of 500 geometries (strides 1-2, Ci
    3 and multiples of 4 and 8, pools 1-2, both types), because they
    share one implementation; K3's and K4's tiles at phi3-medium-14b's
    and mixtral-8x7b's shapes pass; the ``__launch_bounds__`` the rules
    assume are the sources'.

The reference runs as its own tests run it: planner, accountant and
``audit_graph`` at ``interpret`` (no Pallas kernel), and ``target=
"lax"`` for the forwards.
"""

import dataclasses
import itertools
import re

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.analysis import plan_check as jpc
from repro.kernels.conv_lb import ops as jops
from repro.models import cnn as jcnn
from repro_torch.analysis import plan_check as pc
from repro_torch.core.hopper_adapter import (REGS_PER_SM, SMEM_PER_BLOCK,
                                             launch_bounds_regs)
from repro_torch.kernels.attention_block import kernel as K4
from repro_torch.kernels.conv_lb import im2col as I
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb import ops
from repro_torch.kernels.conv_lb import wgrad as W
from repro_torch.kernels.matmul_lb import kernel as K3
from repro_torch.models import cnn
from repro_torch.models.graph import ConvGraph, graph_plan_handles

MIB = 1 << 20
F32, BF16 = torch.float32, torch.bfloat16
_PLAN_FIELDS = ("ho", "wo", "ho_pad", "wo_pad", "hp_pad", "wp_pad",
                "ci_pad", "co_pad", "stride", "dilation", "hk", "wk",
                "pool", "lhs_dilation", "h", "w", "ci", "co", "py", "px",
                "residual")


def _vgg_shapes(width_mult=1.0):
    """VGG16 params as shapes alone (both packages read only
    ``w.shape``)."""
    return {"convs": [{"w": np.empty((3, 3, ci, co), np.float32)}
                      for _, ci, co, *_ in cnn.vgg_layer_dims(width_mult)]}


def _nets():
    shapes = _vgg_shapes()
    return {"vgg": (jcnn.vgg_graph(shapes), cnn.vgg_graph(shapes), 224),
            "resnet": (jcnn.resnet_graph(), cnn.resnet_graph(), 32)}


NETS = _nets()


def _same_conv_plan(plan, rplan):
    assert dataclasses.asdict(plan.blocks) == \
        dataclasses.asdict(rplan.blocks)
    for f in _PLAN_FIELDS:
        assert getattr(plan, f) == getattr(rplan, f), f


def _traffic(t):
    return (t.reads_in, t.reads_w, t.reads_out, t.writes_out)


# --------------------------------------------------------------------------
# interpret: the reference's acceptance audits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model,training,n", [
    ("vgg", True, 39), ("resnet", True, 63), ("resnet", False, 21)])
def test_audit_graph_equals_the_reference(model, training, n):
    ref_graph, graph, size = NETS[model]
    kw = dict(batch=8, vmem_budget=MIB, training=training)
    ref = jpc.audit_graph(ref_graph, size, size, **kw)
    got = pc.audit_graph(graph, size, size, **kw)
    assert got.target == ref.target == "interpret"
    assert (got.n_plans, got.n_legal, got.legal_frac,
            got.traffic_mismatches, got.bound_mismatches, got.ok) == \
        (ref.n_plans, ref.n_legal, ref.legal_frac, ref.traffic_mismatches,
         ref.bound_mismatches, ref.ok) == (n, n, 1.0, 0, 0, True)
    assert got.report().splitlines()[0] == ref.report().splitlines()[0] \
        == f"plan audit [interpret]: {n}/{n} legal, 0 traffic " \
           f"mismatch(es), 0 bound mismatch(es)"
    assert got.report() == ref.report()
    assert all(e.route is None and e.launch is None for e in got.entries)


def test_mosaic_conv_audit_raises_naming_sm90():
    _, graph, size = NETS["resnet"]
    with pytest.raises(ValueError, match="sm90"):
        pc.audit_graph(graph, size, size, batch=8, target="mosaic")
    with pytest.raises(ValueError, match="unknown audit target"):
        pc.audit_graph(graph, size, size, batch=8, target="tpu")


def test_rules_table_copies_the_reference_for_the_rules_the_port_checks():
    ported = {r: t for r, t in pc.RULES.items() if not r.startswith("sm90.")}
    assert set(ported) <= set(jpc.RULES)
    assert all(jpc.RULES[r] == t for r, t in ported.items())
    assert set(jpc.RULES) - set(ported) == {"mosaic.offset",
                                            "autotune.mosaic"}
    assert {r for r in pc.RULES if r.startswith("sm90.")} == {
        "sm90.smem", "sm90.grid", "sm90.tma", "sm90.regs", "sm90.args",
        "sm90.stage", "sm90.fma"}


# --------------------------------------------------------------------------
# ConvPlan: compact_geometry, training_traffic, explain
# --------------------------------------------------------------------------

def _plan_pair(h, ci, co, hk, s, ld, pad, budget, batch=2):
    kw = dict(batch=batch, stride=(s, s), padding=(pad, pad),
              lhs_dilation=(ld, ld), vmem_budget=budget)
    return (ops.plan_conv(h, h + 1, ci, co, hk, hk, **kw),
            jops.plan_conv(h, h + 1, ci, co, hk, hk, **kw))


@settings(max_examples=40, deadline=None)
@given(st.integers(4, 20), st.integers(1, 16), st.integers(1, 16),
       st.integers(1, 3), st.integers(1, 2), st.integers(1, 3),
       st.integers(0, 2), st.sampled_from([None, MIB, 64 * 1024]))
def test_compact_geometry_equals_the_reference(h, ci, co, hk, s, ld, pad,
                                                budget):
    plan, ref = _plan_pair(h, ci, co, hk, s, ld, pad, budget)
    _same_conv_plan(plan, ref)
    assert plan.lhs_dilated == ref.lhs_dilated == (ld > 1)
    assert plan.grid == ref.grid
    assert plan.compact_geometry() == ref.compact_geometry()


@settings(max_examples=40, deadline=None)
@given(st.integers(4, 20), st.integers(1, 16), st.integers(1, 16),
       st.integers(1, 3), st.integers(1, 2), st.integers(0, 1),
       st.sampled_from([None, MIB]), st.integers(1, 8))
def test_training_traffic_equals_the_reference(h, ci, co, hk, s, pad,
                                               budget, batch):
    plan, ref = _plan_pair(h, ci, co, hk, s, 1, pad, budget, batch)
    for autotune in (True, False):
        got = plan.training_traffic(batch, vmem_budget=budget,
                                    autotune=autotune)
        want = ref.training_traffic(batch, vmem_budget=budget,
                                    autotune=autotune)
        for p in ("fwd", "dgrad", "wgrad"):
            assert _traffic(getattr(got, p)) == _traffic(getattr(want, p))
        assert got.total == want.total and got.bwd_share == want.bwd_share


def _explain_cases():
    return [(56, 128, 256, 3, 1, 1, 1, MIB, 8),        # paper-budget plan
            (16, 8, 8, 3, 1, 1, 1, None, 1),           # default budget
            (9, 8, 8, 3, 1, 2, 2, MIB, 2),             # lhs-dilated
            (32, 16, 32, 3, 2, 1, 1, 4096, 4),         # over its budget
            (14, 512, 512, 3, 1, 1, 1, MIB, 8)]


@pytest.mark.parametrize("case", _explain_cases())
def test_explain_equals_the_reference_but_the_verifier_line(case):
    h, ci, co, hk, s, ld, pad, budget, batch = case
    plan, ref = _plan_pair(h, ci, co, hk, s, ld, pad, budget, batch)
    for plan_budget in (budget, 2048):
        head = "\n  verifier [interpret]: "
        got, got_v = plan.explain(batch=batch,
                                  vmem_budget=plan_budget).split(head)
        want, want_v = ref.explain(batch=batch,
                                   vmem_budget=plan_budget).split(head)
        assert got.splitlines() == want.splitlines()
        assert len(got.splitlines()) == 5
        # the exception: the reference's verifier also lists its
        # mosaic.* (TPU alignment) warnings; the port's is the
        # reference's findings without them
        jdiags = jpc.check_conv_plan(ref, batch=batch,
                                     vmem_budget=plan_budget)
        kept = [d for d in jdiags if not d.rule.startswith("mosaic.")]
        assert want_v == jpc.format_diagnostics(jdiags)
        assert got_v == jpc.format_diagnostics(kept)


@pytest.mark.parametrize("dtype,route", [(F32, "sm90_tf32"),
                                         (BF16, "sm90")])
def test_explain_sm90_names_the_launch(dtype, route):
    plan = ops.plan_conv(56, 56, 128, 256, 3, 3, batch=8, padding=(1, 1))
    lines = plan.explain(batch=8, target="sm90", dtype=dtype).splitlines()
    rt, kplan, conv = plan.launch(8, dtype)
    assert rt == route
    facts = K.launch_facts("conv_lb", rt, kplan, conv, dtype)[0]
    assert lines[-2] == (
        f"  launch @B=8 {str(dtype)[6:]}: {route} tile {kplan.tile}; "
        f"{facts.source} smem {facts.smem_bytes} B grid {facts.grid}")
    assert lines[-1] == "  verifier [sm90]: clean"
    assert lines[:-2] == plan.explain(batch=8).splitlines()[:-1]
    # conv1_1's two launches: the staging plane, then its 1x1 conv
    c11 = ops.plan_conv(224, 224, 3, 64, 3, 3, batch=2, padding=(1, 1))
    line = c11.explain(batch=2, target="sm90").splitlines()[-2]
    assert "sm90_im2col" in line and "wgrad_im2col smem 0 B" in line \
        and "conv_lb_sm90_tf32 smem" in line


# --------------------------------------------------------------------------
# the VGG helpers and the two forwards
# --------------------------------------------------------------------------

def _broken_chain():
    shapes = _vgg_shapes(0.25)
    shapes["convs"][3]["w"] = np.empty((3, 3, 5, 32), np.float32)
    return shapes


@pytest.mark.parametrize("params,h,in_ch", [
    (_vgg_shapes(), 224, 3), (_vgg_shapes(0.25), 32, 3),
    (_vgg_shapes(0.25), 20, 3), (_broken_chain(), 64, 3),
    (_vgg_shapes(), 224, 4)])
def test_vgg_conv_geometry_equals_the_reference(params, h, in_ch):
    got = cnn.vgg_conv_geometry(params, h, h + 8, in_ch)
    want = jcnn.vgg_conv_geometry(params, h, h + 8, in_ch)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    for strict in (True, False):
        try:
            want = jcnn.vgg_conv_geometry(params, h, h + 8, in_ch,
                                          strict=strict)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                cnn.vgg_conv_geometry(params, h, h + 8, in_ch,
                                      strict=strict)
            continue
        got = cnn.vgg_conv_geometry(params, h, h + 8, in_ch, strict=strict)
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in want]
    layers = cnn.vgg_conv_layers_for(params, h, h + 8, batch=3,
                                     in_ch=in_ch)
    assert [dataclasses.astuple(x) for x in layers] == \
        [dataclasses.astuple(x) for x in jcnn.vgg_conv_layers_for(
            params, h, h + 8, batch=3, in_ch=in_ch)]


@pytest.mark.parametrize("budget,training", [(None, False), (MIB, False),
                                             (MIB, True)])
def test_vgg_plan_handles_equal_the_reference(budget, training):
    params = _vgg_shapes()
    kw = dict(batch=4, vmem_budget=budget, training=training)
    got = cnn.vgg_plan_handles(params, 224, 224, **kw)
    want = jcnn.vgg_plan_handles(params, 224, 224, **kw)
    assert len(got) == len(want) == 13
    for (layer, h), (rlayer, rh) in zip(got, want):
        assert dataclasses.astuple(layer) == dataclasses.astuple(rlayer)
        if training:
            _same_conv_plan(h.fwd, rh.fwd)
            _same_conv_plan(h.dgrad, rh.dgrad)
            assert dataclasses.asdict(h.wgrad) == dataclasses.asdict(rh.wgrad)
            assert h.dgrad_kernel == rh.dgrad_kernel
        else:
            _same_conv_plan(h, rh)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _close(got, want):
    want = torch.from_numpy(np.array(want))
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-6, err


def test_vgg_forward_matches_the_reference_lax_forward():
    jparams = jcnn.init_vgg(jax.random.PRNGKey(3), width_mult=0.125)
    images = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = jcnn.vgg_forward(jparams, images, target="lax")
    _close(cnn.vgg_forward(_to_torch(jparams), torch.from_numpy(images)),
           want)


def test_resnet_forward_matches_the_reference_lax_forward():
    jgraph = jcnn.resnet_graph(width_mult=0.5)
    jparams = jcnn.init_resnet(jax.random.PRNGKey(4), jgraph)
    images = np.random.default_rng(1).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    want = jcnn.resnet_forward(jgraph, jparams, images, target="lax")
    got = cnn.resnet_forward(cnn.resnet_graph(width_mult=0.5),
                             _to_torch(jparams), torch.from_numpy(images))
    _close(got, want)


# --------------------------------------------------------------------------
# sm90: the launch plans of both nets
# --------------------------------------------------------------------------

#: K1's forward route per VGG layer: conv1_1 (Ci = 3) on the plane
VGG_FWD = {F32: ["sm90_im2col"] + ["sm90_tf32"] * 12,
           BF16: ["sm90_im2col"] + ["sm90"] * 12}


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("model", ["vgg", "resnet"])
def test_sm90_audit_is_clean(model, dtype, batch):
    _, graph, size = NETS[model]
    audit = pc.audit_graph(graph, size, size, batch=batch, target="sm90",
                           dtype=dtype)
    n = 3 * len(graph.nodes)
    assert (audit.target, audit.n_plans, audit.n_legal,
            audit.traffic_mismatches, audit.bound_mismatches) == \
        ("sm90", n, n, 0, 0), audit.report()
    assert audit.ok
    assert audit.report().startswith(f"plan audit [sm90]: {n}/{n} legal")
    for e in audit.entries:
        assert e.route in K.ROUTES + ("sm90_tf32",)
        assert e.launch is not None
        # a warning only where the route is FMA's
        assert {d.rule for d in e.diagnostics} == \
            ({"sm90.fma"} if e.route == "fma" else set()), e.name
    # the accounting entries are the interpret audit's
    acct = pc.audit_graph(graph, size, size, batch=batch)
    assert [(e.name, e.words, e.bound) for e in audit.entries] == \
        [(e.name, e.words, e.bound) for e in acct.entries]
    fwd = [e.route for e in audit.entries if e.name.endswith("/fwd")]
    fma = [e.name for e in audit.entries if e.route == "fma"]
    if model == "vgg":
        # every launch on the tensor cores but conv1_1's dgrad (Ci 3 as
        # the dgrad's Co), which a step never runs: the images need no
        # gradient
        assert fwd == VGG_FWD[dtype]
        assert fma == ["conv1_1/dgrad"]
    elif dtype == F32:
        assert fma == ["stem/dgrad"]
    else:
        # bf16 strides: the four strided convs' forward, dgrad and wgrad
        assert fma == ["stem/dgrad"] + [
            f"s{i}b0_{c}/{p}" for i in (2, 3) for c in ("proj", "a")
            for p in ("fwd", "dgrad", "wgrad")]


def test_sm90_entries_are_the_launchers_plans():
    """Each entry's plan is what the launchers' own route functions pick
    for CPU stand-ins of the operands (aligned, as allocations are)."""
    _, graph, _ = NETS["resnet"]
    handles = graph_plan_handles(graph, 32, 32, batch=4, training=True)
    audit = pc.audit_handles(handles, batch=4, target="sm90")
    for (layer, tp), fwd, dgrad, wgrad in zip(
            handles, *(audit.entries[i::3] for i in range(3))):
        x = torch.empty((4, layer.hi, layer.wi, layer.ci))
        w = torch.empty((layer.hk, layer.wk, layer.ci, layer.co))
        s, p = (layer.stride,) * 2, (layer.pad,) * 2
        pool = tp.fwd.pool
        assert (fwd.route, fwd.launch) == K.plan_of(
            x, w, stride=s, padding=p, pool=pool)
        gy = torch.empty((4, layer.ho, layer.wo, layer.co))
        geom = W.WgradGeometry(hk=layer.hk, wk=layer.wk, stride=s, padding=p)
        assert (wgrad.route, wgrad.launch) == W.plan_of(x, gy, geom)
        if K.dgrad_route(gy, w, s, layer.hi, layer.wi, p) == "sm90_tf32":
            assert dgrad.launch == K.dgrad_plan(
                F32, tuple(gy.shape), tuple(w.shape), s, p, (1, 1),
                layer.hi, layer.wi)


def test_sm90_holds_at_the_resnet_stem_at_batch_65536():
    stem = ConvGraph(name="stem", nodes=(cnn.resnet_graph().nodes[0],))
    for dtype in (F32, BF16):
        audit = pc.audit_graph(stem, 32, 32, batch=65536, target="sm90",
                               dtype=dtype, training=False)
        (e,) = audit.entries
        assert audit.ok and e.route == "sm90_im2col", audit.report()
        b, h, w, ci, ho, wo, cp, elt = (65536, 32, 32, 3, 32, 32, 32,
                                        dtype.itemsize)
        assert I.stage_grid(ho, wo, cp, elt, b)[0] == \
            (32 * 32 * elt // 16 + 255) // 256 * 32 * 65536
        # the staging launch's facts carry the plane the rule reads
        facts = K.launch_facts("conv_lb", e.route, e.launch,
                               ((b, h, w, ci), (3, 3, 3, 16), (1, 1),
                                (1, 1), (1, 1), (1, 1), 1), dtype)
        assert facts[0].stage == (b, h, w, ci, ho, wo, cp, elt)
        assert not pc.check_launch(facts[0])


# --------------------------------------------------------------------------
# sm90: each rule fires on a broken plan
# --------------------------------------------------------------------------

VGG_C = ((8, 56, 56, 128), (3, 3, 128, 256), (1, 1), (1, 1), (1, 1),
         (1, 1), 1)


def _rules(diags):
    return {d.rule for d in pc.errors(diags)}


def test_sm90_smem_fires_one_weight_stage_past_the_fit():
    rt, plan = K.launch_plan(F32, *VGG_C)
    assert rt == "sm90_tf32" and not pc.check_launch_plan(
        "conv_lb", rt, plan, VGG_C, F32)
    over = K.tf32_overfull(plan, 3, 3)

    def smem(stages):
        return K.sm90_tf32_layout(plan.bb, plan.ty, plan.tx, plan.bn, 3, 3,
                                  (1, 1), (1, 1), stages)["smem_bytes"]

    most = max(s for s in range(K.TF32_W_STAGES, 64)
               if smem(s) <= SMEM_PER_BLOCK)
    assert over.smem_bytes == smem(most + 1) > SMEM_PER_BLOCK
    assert _rules(pc.check_launch_plan("conv_lb", rt, over, VGG_C, F32)) \
        == {"sm90.smem"}
    assert not K._tf32_fits(dataclasses.asdict(over))
    # a ring sized to the shared memory needs two stages
    wplan = W.sm90_wgrad_plan(8, 56, 56, 128, 256, 3, 3)
    bad = dataclasses.replace(wplan, stages=1)
    shape = ((8, 56, 56, 128), (8, 56, 56, 256), W.WgradGeometry(3, 3))
    assert _rules(pc.check_launch_plan("wgrad_lb", "sm90", bad, shape,
                                       BF16)) == {"sm90.smem"}


def test_sm90_grid_fires_on_a_z_of_65536():
    shape = ((8, 56, 56, 128), (8, 56, 56, 256),
             W.WgradGeometry(3, 3, padding=(1, 1)))
    rt, plan = W.launch_plan(F32, shape[0], 256, shape[2])
    assert rt == "sm90_tf32"
    assert not pc.errors(pc.check_launch_plan("wgrad_lb", rt, plan, shape,
                                              F32))
    for splits, bad in ((65535, False), (65536, True)):
        p = dataclasses.replace(plan, splits=splits)
        assert (_rules(pc.check_launch_plan("wgrad_lb", rt, p, shape, F32))
                == {"sm90.grid"}) is bad
    assert pc.grid_rule((2 ** 31 - 1, 65535, 65535)) is None
    assert pc.grid_rule((2 ** 31, 1, 1)).rule == "sm90.grid"
    assert pc.grid_rule((1, 0, 1)).rule == "sm90.grid"


def test_sm90_tma_fires_on_a_box_of_257_and_a_misaligned_stride():
    rt, plan = K.launch_plan(BF16, *VGG_C)
    assert rt == "sm90"
    ok = dataclasses.replace(plan, hx=256)
    bad = dataclasses.replace(plan, hx=257)
    assert not pc.check_launch_plan("conv_lb", rt, ok, VGG_C, BF16)
    assert _rules(pc.check_launch_plan("conv_lb", rt, bad, VGG_C, BF16)) \
        == {"sm90.tma"}
    assert not K._sm90_fits(dataclasses.asdict(bad))
    # Ci = 12 in bf16: a 24-byte pixel, no 16-byte row pitch
    c12 = ((8, 56, 56, 12), (3, 3, 12, 256), *VGG_C[2:])
    assert K.launch_plan(BF16, *c12)[0] == "fma"
    diags = pc.errors(pc.check_launch_plan("conv_lb", "sm90", plan, c12,
                                           BF16))
    assert {d.rule for d in diags} == {"sm90.tma"}
    assert "(24, 1344, 75264)" in diags[0].message
    # a traversal stride past 8
    tplan = K.launch_plan(F32, *VGG_C)[1]
    assert _rules(pc.check_launch_plan(
        "conv_lb", "sm90_tf32", dataclasses.replace(tplan, es=(9, 1)),
        VGG_C, F32)) == {"sm90.tma"}
    # a base TMA cannot take
    facts = K.launch_facts("conv_lb", rt, plan, VGG_C, BF16)[0]
    moved = dataclasses.replace(facts, maps=(dataclasses.replace(
        facts.maps[0], aligned=False),) + facts.maps[1:])
    assert _rules(pc.check_launch(moved)) == {"sm90.tma"}


def test_sm90_regs_fires_on_too_many_registers():
    rt, plan = K.launch_plan(F32, *VGG_C)
    assert launch_bounds_regs(K.SM90_THREADS, 1) == 168
    name = "_ZN6_GLOBAL24conv_lb_sm90_tf32_kernelILi{}ELb0EEEv"
    regs = {"conv_lb_sm90_tf32": {name.format(64): 168,
                                  name.format(128): 168}}
    assert not pc.check_launch_plan("conv_lb", rt, plan, VGG_C, F32,
                                    regs=regs)
    regs["conv_lb_sm90_tf32"][name.format(32)] = 176
    assert _rules(pc.check_launch_plan("conv_lb", rt, plan, VGG_C, F32,
                                       regs=regs)) == {"sm90.regs"}
    # a launch is held to the kernels its function names: K4's sm90
    # kernel at width 256 runs 256 threads and may hold 228 registers,
    # at 128 it runs 384 and may not
    k4 = {"attention_block_sm90": {"_Z21attention_sm90_kernelILi256EEEv": 228,
                                   "_Z21attention_sm90_kernelILi128EEEv": 168}}
    for width, ok in ((256, True), (128, True)):
        assert (not pc.check_launch_plan("attention", "sm90", width,
                                         (4, 512, 512, width, 1), BF16,
                                         regs=k4)) is ok
    k4["attention_block_sm90"]["_Z21attention_sm90_kernelILi128EEEv"] = 228
    assert _rules(pc.check_launch_plan("attention", "sm90", 128,
                                       (4, 512, 512, 128, 1), BF16,
                                       regs=k4)) == {"sm90.regs"}
    facts = K.launch_facts("conv_lb", rt, plan, VGG_C, F32)[0]
    assert pc.with_registers(facts, {}) is facts
    # the FMA kernel's plans assume two CTAs an SM: 128 registers fit,
    # a third CTA would not
    assert K.CTAS_PER_SM == 2 and K.MAX_REGS == 128
    assert pc.regs_rule(256, 2, 2, 128) is None
    assert pc.regs_rule(256, 2, 3, 128).rule == "sm90.regs"
    assert pc.regs_rule(256, 1, 2, 129).rule == "sm90.regs"   # 136 x 512
    assert 136 * 512 > REGS_PER_SM >= 128 * 512


def test_sm90_args_stage_and_fma():
    rt, plan = K.launch_plan(BF16, *VGG_C)
    bad = dataclasses.replace(plan, win_off=plan.win_off * 15)   # 135
    assert _rules(pc.check_launch_plan("conv_lb", rt, bad, VGG_C, BF16)) \
        == {"sm90.args"}
    # a plane the staging kernel does not take: 72 channels
    c11 = ((2, 32, 32, 8), (3, 3, 8, 64), (1, 1), (1, 1), (1, 1), (1, 1),
           1)
    assert K.launch_plan(F32, *c11)[0] == "sm90_tf32"
    inner = K.sm90_tf32_plan(2, 32, 32, 64, 72)
    wide = I.Im2colPlan(72, I.im2col_taps(3, 3, (1, 1)), inner)
    assert _rules(pc.check_launch_plan("conv_lb", "sm90_im2col", wide, c11,
                                       F32)) == {"sm90.stage"}
    # an FMA route is a warning, not an error
    lhs = ((2, 9, 9, 8), (3, 3, 8, 8), (1, 1), (2, 2), (1, 1), (2, 2), 1)
    rt, plan = K.launch_plan(F32, *lhs)
    diags = pc.check_launch_plan("conv_lb", rt, plan, lhs, F32)
    assert rt == "fma" and [(d.rule, d.severity) for d in diags] == \
        [("sm90.fma", "warn")]


# --------------------------------------------------------------------------
# sm90: the launchers' fit predicates are the checker's rules
# --------------------------------------------------------------------------

_CIS = (3, 4, 8, 12, 16, 24, 32, 64, 128, 256, 512)
_COS = (4, 8, 16, 32, 64, 128, 256, 512)


def _geometries(seed, n=50):
    rng = np.random.default_rng(seed)
    while n:
        k = int(rng.choice([1, 3, 5, 7, 11, 13]))
        d = int(rng.choice([1, 1, 2, 4, 8, 16]))
        s = int(rng.choice([1, 2]))
        pool = int(rng.choice([1, 2]))
        h = int(rng.integers(4, 72))
        pad = int(rng.integers(0, (k - 1) * d // 2 + 1))
        b = int(rng.integers(1, 9))
        ci, co = int(rng.choice(_CIS)), int(rng.choice(_COS))
        dtype = (F32, BF16)[int(rng.integers(2))]
        ho, wo = K._out_plane(h, h + 3, k, k, (s, s), (pad, pad), (d, d),
                              (1, 1))
        if min(ho, wo) < 1 or ho % pool or wo % pool:
            continue
        n -= 1
        yield dtype, ((b, h, h + 3, ci), (k, k, ci, co), (s, s),
                      (pad, pad), (d, d), (1, 1), pool)


def _k1_candidates(dtype, conv):
    """Every tile K1's plan of ``dtype`` ranks, as plans."""
    (b, _, _, ci), (k, _, _, co), stride, _, dil, _, _ = conv
    if dtype == BF16:
        for bn, cib, (bb, ty, tx) in itertools.product(
                K.SM90_BN, K.sm90_cibs(ci), K.SM90_TILES):
            lay = K.sm90_layout(bb, ty, tx, bn, cib, k, k, dil)
            yield "sm90", lay, K.Sm90Plan(**lay, ctas=1), K._sm90_fits(lay)
    else:
        for bn, (bb, ty, tx) in itertools.product(K.TF32_BN, K.SM90_TILES):
            lay = K.sm90_tf32_layout(bb, ty, tx, bn, k, k, dil, stride)
            yield ("sm90_tf32", lay, K.Sm90Tf32Plan(**lay, ctas=1),
                   K._tf32_fits(lay))


def _k2_candidates(dtype, conv):
    (b, _, _, ci), (k, _, _, co), stride, _, dil, _, _ = conv
    if dtype == BF16:
        for (bn, nwc), cib in itertools.product(W.SM90_TILES, W.SM90_CIBS):
            lay = W.sm90_wgrad_layout(bn, nwc, cib, k, k, dil)
            yield "sm90", W.Sm90WgradPlan(
                **lay, nblk=1, splits=1, bps=1, tiles=-(-co // bn),
                ws_bytes=0), W._sm90_fits(lay)
    else:
        for (bn, nwc), cib in itertools.product(W.TF32_TILES, W.TF32_CIBS):
            lay = W.sm90_tf32_wgrad_layout(bn, nwc, cib, ci, k, k, dil,
                                           stride)
            yield "sm90_tf32", W.Sm90Tf32Plan(
                **lay, nblk=1, splits=1, bps=1, tiles=-(-co // bn),
                ws_bytes=0), W._tf32_fits(lay)


@pytest.mark.parametrize("seed", range(10))
def test_fit_predicates_and_checker_agree(seed):
    seen = {True: 0, False: 0}
    for dtype, conv in _geometries(seed):
        x, w, stride, pad, dil, _, pool = conv
        # what the launchers pick passes the checker; an FMA tile that
        # fits nowhere is one the launcher itself refuses (smem_rule)
        rt, plan = K.launch_plan(dtype, *conv)
        errs = _rules(pc.check_launch_plan("conv_lb", rt, plan, conv, dtype))
        assert not errs or (rt == "fma" and errs == {"sm90.smem"}), (
            conv, rt, errs)
        geom = W.WgradGeometry(hk=w[0], wk=w[1], stride=stride, padding=pad,
                               dilation=dil)
        ho, wo = K._out_plane(x[1], x[2], w[0], w[1], stride, pad, dil,
                              (1, 1))
        wshape = (x, (x[0], ho, wo, w[3]), geom)
        wrt, wplan = W.launch_plan(dtype, x, w[3], geom)
        assert not pc.errors(pc.check_launch_plan("wgrad_lb", wrt, wplan,
                                                  wshape, dtype)), conv
        if K.dgrad_on_kernel(w[0], w[1], pad, dil):
            kern, drt, dplan, dshape, _ = K.dgrad_launch(
                dtype, (x[0], ho, wo, w[3]), w, stride, pad, dil, x[1], x[2])
            errs = _rules(pc.check_launch_plan(kern, drt, dplan, dshape,
                                               dtype))
            assert not errs or (drt == "fma" and errs == {"sm90.smem"})
        # every tile the plans rank: fit iff the checker finds no error
        pitch = 8 if dtype == BF16 else 4
        if x[3] % pitch or w[3] % pitch:
            continue                  # no TMA map of x or w: no such tile
        for rt, _, cand, fits in _k1_candidates(dtype, conv):
            errs = pc.errors(pc.check_launch_plan("conv_lb", rt, cand, conv,
                                                  dtype))
            assert fits == (not errs), (conv, cand.tile, errs)
            seen[fits] += 1
        if stride == (1, 1) or dtype == F32:
            for rt, cand, fits in _k2_candidates(dtype, conv):
                errs = pc.errors(pc.check_launch_plan("wgrad_lb", rt, cand,
                                                      wshape, dtype))
                assert fits == (not errs), (conv, cand.tile, errs)
                seen[fits] += 1
        cp = I.im2col_channels(x[3], w[0], w[1])
        stage = (x[0], x[1], x[2], x[3], ho, wo, cp, dtype.itemsize)
        assert I.stage_fits(*stage) == (pc.stage_rule(stage) is None)
    assert seen[True] and seen[False]


def test_fit_sweep_covers_what_it_claims():
    geoms = [g for seed in range(10) for g in _geometries(seed)]
    assert len(geoms) == 500
    assert {c[2] for _, c in geoms} == {(1, 1), (2, 2)}
    assert {c[6] for _, c in geoms} == {1, 2}
    assert {d for d, _ in geoms} == {F32, BF16}
    cis = {c[0][3] for _, c in geoms}
    assert 3 in cis and {4, 8} <= cis and all(
        ci == 3 or ci % 4 == 0 for ci in cis)
    routes = {K.launch_plan(d, *c)[0] for d, c in geoms}
    assert routes == set(K.ROUTES)


# --------------------------------------------------------------------------
# K3, K4 and the sources' launch bounds
# --------------------------------------------------------------------------

#: phi3-medium-14b's projections at 4096 tokens: (m, n, k)
PHI3 = [(4096, 5120, 5120), (4096, 1280, 5120), (4096, 17920, 5120),
        (4096, 5120, 17920)]


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k3_tiles_pass_at_phi3(dtype):
    for m, n, k in PHI3:
        for kmajor in (False, True):
            x = torch.empty((m, k), dtype=dtype)
            w = (torch.empty((n, k), dtype=dtype).t() if kmajor
                 else torch.empty((k, n), dtype=dtype))
            rt, tile = K3.plan_of(x, w)
            assert rt == ("sm90_tf32" if dtype == F32 else "sm90")
            assert not pc.check_launch_plan("matmul_lb", rt, tile,
                                            (m, n, k, kmajor), dtype)
            fma = pc.check_launch_plan("matmul_lb", "fma",
                                       K3.cta_tile(m, n), (m, n, k, kmajor),
                                       dtype)
            assert [d.rule for d in fma] == ["sm90.fma"]
    assert K3.sm90_smem_bytes(256) == 1024 + 4 * (128 + 256) * 64 * 2 + 64
    assert K3.tf32_smem_bytes(128) <= SMEM_PER_BLOCK
    # a row pitch TMA cannot take
    assert _rules(pc.check_launch_plan("matmul_lb", "sm90", 128,
                                       (64, 128, 100, False, 100, 128),
                                       BF16)) == {"sm90.tma"}


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k4_plans_pass_at_phi3_and_mixtral(dtype):
    # b * heads, s, kv heads, hd
    for bh, s, kv, hd in ((40, 4096, 10, 128), (32, 8192, 8, 128)):
        q = torch.empty((bh, s, hd), dtype=dtype)
        k = torch.empty((kv, s, hd), dtype=dtype)
        for via in (None, "fma"):
            rt, plan = K4.plan_of(q, k, k, via)
            assert rt == via or rt == ("sm90_tf32" if dtype == F32
                                       else "sm90")
            diags = pc.check_launch_plan("attention", rt, plan,
                                         (bh, s, s, hd, bh // kv), dtype)
            assert not pc.errors(diags), diags
    assert K4.plan_of(q, k, k, "sm90_tf32")[1] == (
        K4.sm90_tf32_plan(128) if dtype == F32 else None)
    assert K4.sm90_smem_bytes(256) <= SMEM_PER_BLOCK
    # f32 at 256: one stage of K and V, and it fits; two would not
    assert not pc.errors(pc.check_launch_plan(
        "attention", "fma", 256, (8, 512, 512, 256, 1), F32))
    assert K4.attention_smem_bytes(256, F32, 2) > SMEM_PER_BLOCK


#: source stem -> (threads, min_blocks) the rules assume
BOUNDS = {"conv_lb": (256, 2), "conv_lb_sm90": (384, 1),
          "conv_lb_sm90_tf32": (384, 1), "wgrad_lb": (256, 2),
          "wgrad_lb_sm90": (384, 1), "wgrad_lb_sm90_tf32": (384, 1),
          "wgrad_im2col": (256, 1), "matmul_lb": (256, 2),
          "matmul_lb_sm90": (384, 1), "matmul_lb_sm90_tf32": (384, 1),
          "attention_block": (256, 1), "attention_block_sm90": (384, 1),
          "attention_block_sm90_tf32": (384, 1)}


def _source_bounds(path):
    """The ``__launch_bounds__`` of a source's main kernel: threads (its
    ``kThreads``, or a literal) and min blocks."""
    text = path.read_text()
    args = re.search(r"__launch_bounds__\(([^)]*)\)", text).group(1)
    parts = [a.strip() for a in args.split(",")]
    threads = parts[0]
    if not threads.isdigit():
        consumers = re.search(r"kConsumers = (?:HD > 128 \? 1 : )?(\d+)",
                              text)
        kt = re.search(r"kThreads = (\d+);", text)
        threads = (kt.group(1) if kt else
                   str(128 * (1 + int(consumers.group(1)))))
    return int(threads), int(parts[1]) if len(parts) > 1 else 1


def test_launch_bounds_the_rules_assume_are_the_sources():
    sources = [K.SOURCE, K.SM90_SOURCE, K.TF32_SOURCE, W.SOURCE,
               W.SM90_SOURCE, W.TF32_SOURCE, I.SOURCE, K3.SOURCE,
               K3.SM90_SOURCE, K3.TF32_SOURCE, K4.SOURCE, K4.SM90_SOURCE,
               K4.TF32_SOURCE]
    assert {p.stem: _source_bounds(p) for p in sources} == BOUNDS
    # and the facts of each route carry them
    got = {}
    for dtype, conv in itertools.chain(*(_geometries(s, 20)
                                         for s in range(3))):
        rt, plan = K.launch_plan(dtype, *conv)
        for f in K.launch_facts("conv_lb", rt, plan, conv, dtype):
            got[f.source] = (f.threads, f.min_blocks)
    for rt, plan, shape, dtype in (
            ("fma", K3.cta_tile(64, 64), (64, 64, 64, False), F32),
            ("sm90", 128, (64, 128, 64, False), BF16),
            ("sm90_tf32", 64, (64, 128, 64, False), F32)):
        for f in K3.launch_facts("matmul_lb", rt, plan, shape, dtype):
            got[f.source] = (f.threads, f.min_blocks)
    for rt, plan, dtype in (("fma", 128, F32), ("sm90", 128, BF16),
                            ("sm90_tf32", K4.sm90_tf32_plan(128), F32)):
        for f in K4.launch_facts("attention", rt, plan,
                                 (4, 256, 256, 128, 1), dtype):
            got[f.source] = (f.threads, f.min_blocks)
    # K4's sm90 kernel at 256: one consumer warpgroup, 256 threads
    f = K4.launch_facts("attention", "sm90", 256, (4, 256, 256, 256, 1),
                        BF16)[0]
    assert (f.threads, f.grid) == (256, (16, 1, 1))
    assert {s: BOUNDS[s] for s in got} == got
    assert {"conv_lb", "conv_lb_sm90", "conv_lb_sm90_tf32", "wgrad_im2col",
            "matmul_lb", "attention_block_sm90_tf32"} <= set(got)


def test_parse_resource_usage_reads_cuobjdumps_report():
    from repro_torch.kernels.nvcc import parse_resource_usage

    text = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _Z20wgrad_reduce_kernelPKfPfmi:
  REG:16 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:556 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z15wgrad_lb_kernelIfLi128EEvPKT_S2_Pf4Geom:
  REG:128 STACK:8 SHARED:1024 LOCAL:8 CONSTANT[0]:624 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    usage = parse_resource_usage(text)
    assert list(usage) == ["_Z20wgrad_reduce_kernelPKfPfmi",
                           "_Z15wgrad_lb_kernelIfLi128EEvPKT_S2_Pf4Geom"]
    main = usage["_Z15wgrad_lb_kernelIfLi128EEvPKT_S2_Pf4Geom"]
    assert (main["REG"], main["STACK"], main["SHARED"], main["LOCAL"],
            main["CONSTANT[0]"]) == (128, 8, 1024, 8, 624)
    assert usage["_Z20wgrad_reduce_kernelPKfPfmi"]["REG"] == 16
    assert parse_resource_usage("Resource usage:\n Common:\n  GLOBAL:0\n") \
        == {}


def test_parse_ptxas_spills_reads_the_build_log():
    from repro_torch.kernels.nvcc import parse_ptxas_spills

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi128EEvv
    24 bytes stack frame, 16 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""
    assert parse_ptxas_spills(log) == {
        "_Z3fooILi128EEvv": {"stack": 24, "spill_stores": 16,
                             "spill_loads": 20},
        "_Z3barv": {"stack": 0, "spill_stores": 0, "spill_loads": 0}}
