"""The port's dataflow zoo (``repro_torch/core/dataflow.py``), held
against the reference's.

The mirror of ``tests/test_dataflows.py`` (traffic models, the tiling
search, the paper's headline claims), then exact equality with the
reference package on the same inputs: every dataflow's searched tiling
and traffic, ``found_minimum`` and ``network_traffic`` over VGG16's
conv and fc layers, and on the layers the property strategy draws.
Both packages run the same Python float arithmetic, so ``==`` holds
with no tolerance.
"""

import dataclasses

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import dataflow as jdf
from repro.core.layer import ConvLayer as JaxConvLayer
from repro.core.vgg import vgg16_conv_layers as jax_vgg16_conv_layers
from repro.core.vgg import vgg16_fc_layers as jax_vgg16_fc_layers
from repro_torch.core.dataflow import (OursDataflow, Tiling, dataflow_zoo,
                                       found_minimum, network_traffic)
from repro_torch.core.layer import ConvLayer
from repro_torch.core.lower_bound import q_dram_ideal, q_dram_practical
from repro_torch.core.vgg import vgg16_conv_layers, vgg16_fc_layers

S_66 = int(66.5 * 1024 // 2)
S_173 = int(173.5 * 1024 // 2)


def plain(v):
    """A result as plain Python values, so two packages' results
    compare with ``==``."""
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, (tuple, list)):
        return tuple(plain(x) for x in v)
    return v


def jax_layer(layer: ConvLayer) -> JaxConvLayer:
    return JaxConvLayer(**dataclasses.asdict(layer))


@pytest.fixture(scope="module")
def vgg():
    return vgg16_conv_layers(3)


def test_ours_within_12pct_of_bound(vgg):
    lb = sum(q_dram_practical(l, S_173) for l in vgg)
    ours = network_traffic(vgg, S_173, OursDataflow()).total
    assert ours / lb < 1.12


def test_ours_beats_every_other_dataflow(vgg):
    for s in (S_66, S_173):
        results = {df.name: network_traffic(vgg, s, df).total
                   for df in dataflow_zoo()}
        best = min(results, key=results.get)
        assert best == "ours", results


def test_found_minimum_close_to_ours(vgg):
    ours = network_traffic(vgg, S_66, OursDataflow()).total
    fm = sum(found_minimum(l, S_66)[2].total for l in vgg)
    assert fm <= ours
    assert (ours - fm) / fm < 0.05


def test_outputs_written_once(vgg):
    df = OursDataflow()
    for layer in vgg[:4]:
        _, q = df.search(layer, S_66)
        assert q.writes_out == layer.n_outputs
        assert q.reads_out == 0


def test_balanced_input_weight_traffic(vgg):
    q = network_traffic(vgg, S_66, OursDataflow())
    ratio = q.reads_in / q.reads_w
    assert 0.4 < ratio < 2.5


layer_strategy = st.builds(
    ConvLayer, name=st.just("l"), batch=st.integers(1, 4),
    ci=st.integers(4, 128), co=st.integers(4, 128),
    hi=st.integers(8, 56), wi=st.integers(8, 56),
    hk=st.sampled_from([1, 3]), wk=st.sampled_from([1, 3]),
    stride=st.sampled_from([1, 2]), pad=st.sampled_from([0, 1]))


@given(layer_strategy, st.integers(1024, 1 << 16))
@settings(max_examples=30, deadline=None)
def test_search_respects_budget_and_bound(layer, s):
    df = OursDataflow()
    t, q = df.search(layer, s)
    assert df.footprint(layer, t) <= s or t == Tiling().clamp(layer)
    assert q.total >= q_dram_ideal(layer) * 0.999
    assert plain((t, q)) == plain(jdf.OursDataflow().search(
        jax_layer(layer), s))


@given(layer_strategy)
@settings(max_examples=30, deadline=None)
def test_more_memory_never_hurts(layer):
    df = OursDataflow()
    _, q1 = df.search(layer, 2048)
    _, q2 = df.search(layer, 1 << 16)
    assert q2.total <= q1.total * 1.001
    ref = jdf.OursDataflow()
    assert plain(q2) == plain(ref.search(jax_layer(layer), 1 << 16)[1])


def test_fetched_area_exact():
    l = ConvLayer("x", 1, 1, 1, 8, 8, 3, 3, stride=1, pad=1)
    assert l.fetched_area(l.wo, l.ho) == l.hi * l.wi
    area = l.fetched_area(4, 8)
    assert area == (8 + 2) * 8


# --------------------------------------------------------------------------
# exact equality with the reference
# --------------------------------------------------------------------------

def test_vgg16_layers_equal_reference():
    for batch in (1, 3, 8):
        assert plain(vgg16_conv_layers(batch)) == plain(
            jax_vgg16_conv_layers(batch))
        assert plain(vgg16_fc_layers(batch)) == plain(
            jax_vgg16_fc_layers(batch))


@pytest.mark.parametrize("s", [S_66, S_173])
def test_zoo_search_equals_reference_on_vgg16(s):
    layers = vgg16_conv_layers(3) + vgg16_fc_layers(3)
    jlayers = jax_vgg16_conv_layers(3) + jax_vgg16_fc_layers(3)
    zoo, jzoo = dataflow_zoo(), jdf.dataflow_zoo()
    assert [df.name for df in zoo] == [df.name for df in jzoo]
    for df, jd in zip(zoo, jzoo):
        for layer, jl in zip(layers, jlayers):
            t, q = df.search(layer, s)
            assert plain((t, q)) == plain(jd.search(jl, s))
            assert df.traffic(layer, t) == q
            assert df.footprint(layer, t) == jd.footprint(jl, jdf.Tiling(
                **dataclasses.asdict(t)))
        assert plain(network_traffic(layers, s, df)) == plain(
            jdf.network_traffic(jlayers, s, jd))
    for layer, jl in zip(layers, jlayers):
        assert plain(found_minimum(layer, s)) == plain(
            jdf.found_minimum(jl, s))


@given(layer_strategy, st.integers(1024, 1 << 16))
@settings(max_examples=20, deadline=None)
def test_zoo_search_equals_reference_on_drawn_layers(layer, s):
    jl = jax_layer(layer)
    for df, jd in zip(dataflow_zoo(), jdf.dataflow_zoo()):
        assert plain(df.search(layer, s)) == plain(jd.search(jl, s))
    assert plain(found_minimum(layer, s)) == plain(jdf.found_minimum(jl, s))
