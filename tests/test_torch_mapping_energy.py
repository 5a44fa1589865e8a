"""The port's on-chip mapping and energy/performance model
(``repro_torch/core/mapping.py``, ``energy.py``, ``simulator.py``; paper
Sec. IV-B, V, VI), held against the reference's.

The mirror of ``tests/test_mapping_energy.py``, then exact equality
with the reference package: the five implementations, the fitted
tilings, mapping reports, energies and the simulated layers and network
over VGG16's conv layers, and the Table II energy lookups (the same
Python float arithmetic, so ``==`` with no tolerance).  The energy
constants are the paper's 65 nm table, not a measurement of any device.
"""

import dataclasses

import pytest

from repro.core import energy as jen
from repro.core import mapping as jmap
from repro.core import simulator as jsim
from repro.core.dataflow import OursDataflow as JaxOursDataflow
from repro.core.vgg import vgg16_conv_layers as jax_vgg16_conv_layers
from repro_torch.core import energy as en
from repro_torch.core.dataflow import OursDataflow
from repro_torch.core.energy import IMPLEMENTATIONS, layer_energy
from repro_torch.core.lower_bound import energy_lower_bound_pj
from repro_torch.core.mapping import fit_tiling_to_array, map_iteration
from repro_torch.core.simulator import simulate_layer, simulate_network
from repro_torch.core.vgg import vgg16_conv_layers


@pytest.fixture(scope="module")
def vgg():
    return vgg16_conv_layers(3)


@pytest.fixture(scope="module")
def impl1():
    return IMPLEMENTATIONS[0]


def test_table1_effective_memory():
    for impl, kb in zip(IMPLEMENTATIONS, (66.5, 66.5, 66.5, 131.625,
                                          131.625)):
        assert impl.array.effective_s * 2 / 1024 == pytest.approx(kb,
                                                                  rel=0.01)


def test_weights_gbuf_exactly_once(vgg, impl1):
    df = OursDataflow()
    for layer in vgg[:4]:
        t = fit_tiling_to_array(layer, impl1.array)
        dram = df.traffic(layer, t)
        rep = map_iteration(layer, t, impl1.array, dram)
        assert rep.gbuf_reads_w == pytest.approx(dram.reads_w)
        assert rep.gbuf_writes_w == pytest.approx(dram.reads_w)


def test_input_halo_factor_band(vgg, impl1):
    df = OursDataflow()
    layer = vgg[5]
    t = fit_tiling_to_array(layer, impl1.array)
    dram = df.traffic(layer, t)
    rep = map_iteration(layer, t, impl1.array, dram)
    assert 1.0 <= rep.gbuf_reads_in / dram.reads_in < 2.6


def test_reg_writes_reach_lower_bound(vgg, impl1):
    df = OursDataflow()
    for layer in vgg[:3]:
        t = fit_tiling_to_array(layer, impl1.array)
        rep = map_iteration(layer, t, impl1.array, df.traffic(layer, t))
        assert rep.lreg_writes == layer.macs


def test_reg_total_close_to_bound(vgg, impl1):
    df = OursDataflow()
    layer = vgg[6]
    t = fit_tiling_to_array(layer, impl1.array)
    rep = map_iteration(layer, t, impl1.array, df.traffic(layer, t))
    assert rep.reg_total / layer.macs < 1.8


def test_fixed_split_overhead_small(vgg):
    from repro_torch.core.dataflow import network_traffic
    impl = IMPLEMENTATIONS[0]
    free = network_traffic(vgg, impl.array.effective_s,
                           OursDataflow()).total
    fixed = sum(simulate_layer(l, impl).dram.total for l in vgg)
    assert fixed / free < 1.06


def test_energy_gap_band(vgg):
    for impl in IMPLEMENTATIONS:
        r = simulate_network(vgg, impl)
        s = impl.array.effective_s
        lreg_pj = {256: 3.39, 128: 1.92, 64: 1.16}[impl.lreg_bytes]
        bound = sum(energy_lower_bound_pj(l, s, dram_pj=427.9,
                                          mac_pj=4.16, reg_pj=lreg_pj)
                    for l in vgg)
        gap = r.total_energy_pj / bound - 1
        assert 0.0 < gap < 1.0, (impl.name, gap)


def test_more_pes_faster(vgg):
    t1 = simulate_network(vgg, IMPLEMENTATIONS[0]).total_time_s
    t3 = simulate_network(vgg, IMPLEMENTATIONS[2]).total_time_s
    t5 = simulate_network(vgg, IMPLEMENTATIONS[4]).total_time_s
    assert t5 < t3 < t1


def test_pe_utilization_high(vgg, impl1):
    df = OursDataflow()
    for layer in vgg[4:8]:
        t = fit_tiling_to_array(layer, impl1.array)
        rep = map_iteration(layer, t, impl1.array, df.traffic(layer, t))
        assert rep.pe_utilization > 0.85


# --------------------------------------------------------------------------
# exact equality with the reference
# --------------------------------------------------------------------------

def test_implementations_equal_reference():
    assert len(IMPLEMENTATIONS) == len(jen.IMPLEMENTATIONS) == 5
    for impl, jimpl in zip(IMPLEMENTATIONS, jen.IMPLEMENTATIONS):
        assert dataclasses.asdict(impl) == dataclasses.asdict(jimpl)
        assert impl.name == jimpl.name
        arr, jarr = impl.array, jimpl.array
        assert (arr.n_pe, arr.psum_capacity, arr.igbuf_entries,
                arr.wgbuf_entries, arr.effective_s) == (
            jarr.n_pe, jarr.psum_capacity, jarr.igbuf_entries,
            jarr.wgbuf_entries, jarr.effective_s)
    for entries in (100, 512, 1000, 2048, 3000, 5000):
        assert en.gbuf_pj(entries) == jen.gbuf_pj(entries)
    for b in (32, 64, 100, 128, 200, 256, 512):
        assert en.lreg_pj(b) == jen.lreg_pj(b)


@pytest.mark.parametrize("idx", range(5))
def test_mapping_and_energy_equal_reference_on_vgg16(idx):
    impl, jimpl = IMPLEMENTATIONS[idx], jen.IMPLEMENTATIONS[idx]
    layers, jlayers = vgg16_conv_layers(3), jax_vgg16_conv_layers(3)
    df, jdf = OursDataflow(), JaxOursDataflow()
    for layer, jl in zip(layers, jlayers):
        t = fit_tiling_to_array(layer, impl.array)
        jt = jmap.fit_tiling_to_array(jl, jimpl.array)
        assert dataclasses.asdict(t) == dataclasses.asdict(jt)
        dram, jdram = df.traffic(layer, t), jdf.traffic(jl, jt)
        assert dataclasses.asdict(dram) == dataclasses.asdict(jdram)
        rep = map_iteration(layer, t, impl.array, dram)
        jrep = jmap.map_iteration(jl, jt, jimpl.array, jdram)
        assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
        assert (rep.gbuf_total, rep.reg_total) == (jrep.gbuf_total,
                                                   jrep.reg_total)
        e = layer_energy(layer.macs, dram.total, rep, impl)
        je = jen.layer_energy(jl.macs, jdram.total, jrep, jimpl)
        assert dataclasses.asdict(e) == dataclasses.asdict(je)
        assert e.total_pj == je.total_pj
        r, jr = simulate_layer(layer, impl), jsim.simulate_layer(jl, jimpl)
        assert dataclasses.asdict(r) == dataclasses.asdict(jr)
        assert r.pj_per_mac == jr.pj_per_mac
    n, jn = simulate_network(layers, impl), jsim.simulate_network(jlayers,
                                                                  jimpl)
    assert dataclasses.asdict(n) == dataclasses.asdict(jn)
    for prop in ("total_time_s", "total_macs", "total_energy_pj",
                 "pj_per_mac", "gops", "dram_mb", "gbuf_mb",
                 "reg_accesses"):
        assert getattr(n, prop) == getattr(jn, prop), prop
