"""Three-term roofline of a dry-run cell — the port's copy of
``repro/analysis/roofline.py``, on the H100's published rates.

  compute term    = FLOPs_per_rank / peak_FLOP/s (bf16, dense)
  memory term     = bytes_per_rank / HBM rate
  collective term = collective_bytes_per_rank / NVLink rate (one
                    direction)

The reference reads FLOPs, bytes and collective bytes from the
partitioned XLA module of one chip; the port reads the counts of one
rank's step run on the ``meta`` device (:mod:`repro_torch.launch.dryrun`):
the FLOPs of ``torch.utils.flop_counter.FlopCounterMode``, the operand
and result bytes of every aten op (an unfused upper bound: a fused
kernel moves less) and the bytes its collectives send, by op.  They are
one rank's already.  The dominant term is the bottleneck;
MODEL_FLOPS / FLOPs exposes remat, padding and causal-masking waste.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hopper_adapter import (HBM_BYTES_PER_S,
                                             NVLINK_BYTES_PER_S,
                                             PEAK_BF16_FLOPS)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    model_flops: float
    peak_memory_bytes: float | None = None
    coll_detail: dict | None = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / NVLINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_bound(self) -> float:
        """Lower bound on step time: overlapped terms -> max()."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs: remat/padding waste."""
        if self.flops_per_chip <= 0:
            return 0.0
        return self.model_flops / self.flops_per_chip

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline the step achieves, assuming
        perfect overlap: useful-compute-time / bound."""
        useful_t = self.model_flops / PEAK_BF16_FLOPS
        return useful_t / max(self.step_time_bound, 1e-30)

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.t_compute*1e3:.1f} | {self.t_memory*1e3:.1f} "
                f"| {self.t_collective*1e3:.1f} | {self.bottleneck} "
                f"| {self.useful_flops_fraction:.2f} "
                f"| {self.roofline_fraction:.2f} |")


def model_flops_train(cfg, seq_len: int, global_batch: int,
                      chips: int) -> float:
    """6*N_active*D per chip (3x forward for fwd+bwd)."""
    n = cfg.active_param_count()
    d = seq_len * global_batch
    return 6.0 * n * d / chips


def model_flops_decode(cfg, global_batch: int, chips: int) -> float:
    """2*N_active per generated token (forward only)."""
    n = cfg.active_param_count()
    return 2.0 * n * global_batch / chips


def model_flops_prefill(cfg, seq_len: int, global_batch: int,
                        chips: int) -> float:
    n = cfg.active_param_count()
    return 2.0 * n * seq_len * global_batch / chips


def build_roofline(arch: str, shape_name: str, mesh_name: str,
                   counts: dict, cfg, kind: str, seq_len: int,
                   global_batch: int, chips: int) -> Roofline:
    """``counts``: one rank's ``flops`` and ``bytes`` and its
    collectives' ``{op: {"calls", "bytes"}}`` (``collectives``), as the
    dry-run counts them."""
    if kind == "train":
        mf = model_flops_train(cfg, seq_len, global_batch, chips)
    elif kind == "prefill":
        mf = model_flops_prefill(cfg, seq_len, global_batch, chips)
    else:
        mf = model_flops_decode(cfg, global_batch, chips)
    detail = {op: c["bytes"] for op, c in counts["collectives"].items()}
    return Roofline(arch=arch, shape=shape_name, mesh=mesh_name,
                    flops_per_chip=counts["flops"],
                    hbm_bytes_per_chip=counts["bytes"],
                    coll_bytes_per_chip=sum(detail.values()),
                    model_flops=mf, coll_detail=detail)


HEADER = ("| arch | shape | mesh | t_comp(ms) | t_mem(ms) | t_coll(ms) "
          "| bottleneck | useful_flops | roofline_frac |\n"
          "|---|---|---|---|---|---|---|---|---|")
