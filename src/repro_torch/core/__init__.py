"""The paper's primary contribution as an executable library — the
port's copy of ``repro/core/__init__.py``: communication lower bounds
(Sec. III), the bound-attaining dataflow and its competitors (Sec.
IV-A), the on-chip mapping model (Sec. IV-B) and the energy/performance
model (Sec. V/VI).  The energy constants are the paper's 65 nm table,
not a measurement of any device.  Of the reference's TPU adaptation
(``tpu_adapter``) the matmul block geometry (``BlockShape``,
``lb_block_shape``, planned at the reference's budget) and the
mesh-level shard plan are exported, from the Hopper counterpart
:mod:`repro_torch.core.hopper_adapter`."""

from repro_torch.core.layer import (ConvLayer, fc_layer, matmul_layer)
from repro_torch.core.lower_bound import (
    energy_lower_bound_pj, optimal_block, q_dram_ideal, q_dram_naive,
    q_dram_practical, q_dram_theorem2, reg_lower_bound_writes,
    terms_upper_bound)
from repro_torch.core.dataflow import (
    Dataflow, OursDataflow, Tiling, Traffic, dataflow_zoo, found_minimum,
    network_traffic)
from repro_torch.core.mapping import (PEArray, fit_tiling_to_array,
                                      map_iteration)
from repro_torch.core.energy import (IMPLEMENTATIONS, Implementation,
                                     layer_energy)
from repro_torch.core.simulator import (simulate_layer, simulate_network)
from repro_torch.core.hopper_adapter import (BlockShape, ShardPlan,
                                            balanced_shard_plan,
                                            lb_block_shape)
from repro_torch.core.vgg import vgg16_conv_layers, vgg16_fc_layers

__all__ = [
    "ConvLayer", "fc_layer", "matmul_layer",
    "energy_lower_bound_pj", "optimal_block", "q_dram_ideal",
    "q_dram_naive", "q_dram_practical", "q_dram_theorem2",
    "reg_lower_bound_writes", "terms_upper_bound",
    "Dataflow", "OursDataflow", "Tiling", "Traffic", "dataflow_zoo",
    "found_minimum", "network_traffic",
    "PEArray", "fit_tiling_to_array", "map_iteration",
    "IMPLEMENTATIONS", "Implementation", "layer_energy",
    "simulate_layer", "simulate_network",
    "BlockShape", "ShardPlan", "balanced_shard_plan", "lb_block_shape",
    "vgg16_conv_layers", "vgg16_fc_layers",
]
