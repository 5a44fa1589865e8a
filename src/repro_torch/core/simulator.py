"""Cycle-approximate accelerator simulator (paper Sec. VI, Fig. 19).

The port's copy of ``repro/core/simulator.py``.

Performance model: compute time from the mapping's cycle count at
500 MHz; DRAM time from the access volume at 6.4 GB/s (2 bytes/word,
DDR3 per the paper).  Compute and memory partially overlap through the
GBuf prefetch FIFOs, so layer time = max(compute, dram) + ramp."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.dataflow import OursDataflow, Tiling, Traffic
from repro_torch.core.energy import Implementation, EnergyReport, layer_energy
from repro_torch.core.layer import ConvLayer
from repro_torch.core.mapping import MappingReport, fit_tiling_to_array, map_iteration

CORE_HZ = 500e6
DRAM_BYTES_PER_S = 6.4e9
WORD_BYTES = 2


@dataclasses.dataclass(frozen=True)
class LayerResult:
    layer: ConvLayer
    tiling: Tiling
    dram: Traffic
    mapping: MappingReport
    energy: EnergyReport
    time_s: float

    @property
    def pj_per_mac(self) -> float:
        return self.energy.total_pj / self.layer.macs


def simulate_layer(layer: ConvLayer, impl: Implementation) -> LayerResult:
    """Run one layer with the implementation's fixed memory split."""
    df = OursDataflow()
    t = fit_tiling_to_array(layer, impl.array)
    dram = df.traffic(layer, t)
    rep = map_iteration(layer, t, impl.array, dram)
    en = layer_energy(layer.macs, dram.total, rep, impl)
    t_compute = rep.cycles / CORE_HZ
    t_dram = dram.total * WORD_BYTES / DRAM_BYTES_PER_S
    # prefetch overlaps all but the first tile's fill
    ramp = (impl.array.gbuf_entries * WORD_BYTES) / DRAM_BYTES_PER_S
    time_s = max(t_compute, t_dram) + ramp
    return LayerResult(layer=layer, tiling=t, dram=dram, mapping=rep,
                       energy=en, time_s=time_s)


@dataclasses.dataclass(frozen=True)
class NetworkResult:
    layers: list[LayerResult]

    @property
    def total_time_s(self) -> float:
        return sum(r.time_s for r in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(r.layer.macs for r in self.layers)

    @property
    def total_energy_pj(self) -> float:
        return sum(r.energy.total_pj for r in self.layers)

    @property
    def pj_per_mac(self) -> float:
        return self.total_energy_pj / self.total_macs

    @property
    def gops(self) -> float:
        return 2 * self.total_macs / self.total_time_s / 1e9

    @property
    def dram_mb(self) -> float:
        return sum(r.dram.total for r in self.layers) * WORD_BYTES / 1e6

    @property
    def gbuf_mb(self) -> float:
        return sum(r.mapping.gbuf_total for r in self.layers) * WORD_BYTES / 1e6

    @property
    def reg_accesses(self) -> float:
        return sum(r.mapping.reg_total for r in self.layers)


def simulate_network(layers: Sequence[ConvLayer],
                     impl: Implementation) -> NetworkResult:
    return NetworkResult([simulate_layer(l, impl) for l in layers])
