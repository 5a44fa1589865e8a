"""The port's lower-bound math (``repro_torch/core/lower_bound.py``,
paper Sec. III), held against the reference's.

The mirror of ``tests/test_lower_bound.py`` (unit and property tests),
then exact equality with the reference package: every bound function
over VGG16's conv and fc layers at the paper's memory sizes, and on the
layers the property strategy draws (the same Python float arithmetic,
so ``==`` with no tolerance).
"""

import dataclasses
import math

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import lower_bound as jlb
from repro.core.layer import ConvLayer as JaxConvLayer
from repro_torch.core import lower_bound as lb
from repro_torch.core.layer import ConvLayer, fc_layer, matmul_layer
from repro_torch.core.lower_bound import (
    optimal_block, q_dram_ideal, q_dram_naive, q_dram_practical,
    q_dram_theorem2, reg_lower_bound_writes, terms_upper_bound)
from repro_torch.core.vgg import vgg16_conv_layers, vgg16_fc_layers

layer_strategy = st.builds(
    ConvLayer,
    name=st.just("l"),
    batch=st.integers(1, 8),
    ci=st.integers(1, 256),
    co=st.integers(1, 256),
    hi=st.integers(7, 64),
    wi=st.integers(7, 64),
    hk=st.sampled_from([1, 3, 5]),
    wk=st.sampled_from([1, 3, 5]),
    stride=st.sampled_from([1, 2]),
    pad=st.sampled_from([0, 1]),
)


def jax_layer(layer: ConvLayer) -> JaxConvLayer:
    return JaxConvLayer(**dataclasses.asdict(layer))


def test_reuse_factor_eq2():
    l = ConvLayer("x", 1, 3, 64, 32, 32, 3, 3, stride=1, pad=1)
    assert l.reuse_r == 9.0
    l2 = ConvLayer("x", 1, 3, 64, 32, 32, 3, 3, stride=2)
    assert l2.reuse_r == 9.0 / 4


def test_terms_upper_bound_constant():
    assert terms_upper_bound(300, 1.0) == pytest.approx(
        300 * math.sqrt(300) / (3 * math.sqrt(3)))


def test_r1_matches_matmul_bound():
    l = matmul_layer(512, 512, 512)
    s = 4096
    q = q_dram_practical(l, s)
    expected = 2 * l.macs / math.sqrt(s) + l.n_outputs
    assert q == pytest.approx(expected)


@given(layer_strategy, st.integers(64, 1 << 18))
@settings(max_examples=200, deadline=None)
def test_bound_ordering(layer, s):
    q = q_dram_practical(layer, s)
    assert q_dram_ideal(layer) <= q * (1 + 1e-9)
    assert q <= q_dram_naive(layer) + layer.n_outputs


@given(layer_strategy, st.integers(64, 1 << 16))
@settings(max_examples=100, deadline=None)
def test_bound_monotone_in_memory(layer, s):
    assert q_dram_practical(layer, 2 * s) <= q_dram_practical(layer, s) \
        + 1e-9


@given(st.integers(64, 1 << 16), st.floats(1.0, 9.0))
@settings(max_examples=100, deadline=None)
def test_optimal_block_conditions(s, r):
    blk = optimal_block(s, r)
    assert blk.u * blk.z <= s
    if blk.z >= 4:
        assert blk.u / blk.z == pytest.approx(r, rel=0.5)
    assert dataclasses.asdict(blk) == dataclasses.asdict(
        jlb.optimal_block(s, r))


def test_theorem2_scaling():
    l = ConvLayer("x", 4, 128, 128, 56, 56, 3, 3, pad=1)
    q1 = q_dram_theorem2(l, 1 << 12)
    q2 = q_dram_theorem2(l, 1 << 13)
    assert q1 / q2 == pytest.approx(math.sqrt(2), rel=0.1)


def test_reg_lower_bound_is_macs():
    l = ConvLayer("x", 1, 16, 16, 8, 8, 3, 3)
    assert reg_lower_bound_writes(l) == l.macs


def test_fc_layer_is_r1():
    assert fc_layer(3, 4096, 1000).reuse_r == 1.0


# --------------------------------------------------------------------------
# exact equality with the reference
# --------------------------------------------------------------------------

#: the bound functions of one layer at one memory size S
PER_LAYER_S = ("min_partitions", "q_dram_theorem2", "q_dram_practical",
               "q_dram_dgrad", "q_dram_wgrad", "reduction_factor")


def _bounds(mod, layer, s):
    out = {name: getattr(mod, name)(layer, s) for name in PER_LAYER_S}
    out["q_dram_training"] = mod.q_dram_training(layer, s)
    out["q_dram_training_bwd"] = mod.q_dram_training(layer, s, bwd=True)
    out["q_dram_serving"] = mod.q_dram_serving(layer, s, requests=7)
    out["q_dram_ideal"] = mod.q_dram_ideal(layer)
    out["q_dram_naive"] = mod.q_dram_naive(layer)
    out["reg_lower_bound_writes"] = mod.reg_lower_bound_writes(layer)
    out["terms_upper_bound"] = mod.terms_upper_bound(s, layer.reuse_r)
    out["energy_lower_bound_pj"] = mod.energy_lower_bound_pj(
        layer, s, dram_pj=427.9, mac_pj=4.16, reg_pj=3.39)
    out["gbuf_lower_bound_reads"] = mod.gbuf_lower_bound_reads(
        out["q_dram_ideal"], float(layer.n_weights))
    return out


@pytest.mark.parametrize("s", [64, 4096, int(66.5 * 1024 // 2),
                               int(173.5 * 1024 // 2), 1 << 20])
def test_bounds_equal_reference_on_vgg16(s):
    layers = vgg16_conv_layers(3) + vgg16_fc_layers(3)
    for layer in layers:
        assert _bounds(lb, layer, s) == _bounds(jlb, jax_layer(layer), s)
    stages = [(layer, s) for layer in layers]
    jstages = [(jax_layer(layer), s) for layer in layers]
    for bwd in (False, True):
        assert lb.q_dram_graph(stages, bwd=bwd) == jlb.q_dram_graph(
            jstages, bwd=bwd)
    assert lb.q_dram_graph_serving(stages, requests=8) == \
        jlb.q_dram_graph_serving(jstages, requests=8)


@given(layer_strategy, st.integers(64, 1 << 18))
@settings(max_examples=100, deadline=None)
def test_bounds_equal_reference_on_drawn_layers(layer, s):
    assert _bounds(lb, layer, s) == _bounds(jlb, jax_layer(layer), s)
