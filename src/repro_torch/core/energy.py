"""Energy model (paper Tables I & II) and the five accelerator
implementations evaluated in Sec. VI.

The port's copy of ``repro/core/energy.py``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.mapping import MappingReport, PEArray

# --- Table II: energy per operation (pJ), 65nm, 16-bit ----------------------
MAC_PJ = 4.16
DRAM_PJ = 427.9
GBUF_PJ = {512: 0.30, 2048: 1.39, 3200: 2.36}       # entries -> pJ/access
LREG_PJ = {256: 3.39, 128: 1.92, 64: 1.16}          # bytes/PE -> pJ/access
GREG_PJ = 0.06                                       # small latch bank


def gbuf_pj(entries: int) -> float:
    """Nearest Table-II GBuf energy for a given capacity."""
    best = min(GBUF_PJ, key=lambda e: abs(e - entries))
    return GBUF_PJ[best]


def lreg_pj(bytes_per_pe: int) -> float:
    best = min(LREG_PJ, key=lambda b: abs(b - bytes_per_pe))
    return LREG_PJ[best]


# --- Table I: the five implementations --------------------------------------
@dataclasses.dataclass(frozen=True)
class Implementation:
    idx: int
    array: PEArray
    lreg_bytes: int        # per-PE LReg size in bytes (16-bit entries)

    @property
    def name(self) -> str:
        return f"impl{self.idx}"


def _impl(idx: int, p: int, q: int, lreg_b: int, gbuf_kb: float,
          greg_kb: float) -> Implementation:
    entries_per_pe = lreg_b // 2                     # 16-bit words
    return Implementation(
        idx=idx,
        array=PEArray(p=p, q=q, lreg_entries=entries_per_pe,
                      greg_entries=int(greg_kb * 1024) // 2,
                      gbuf_entries=int(gbuf_kb * 1024) // 2),
        lreg_bytes=lreg_b)


IMPLEMENTATIONS = [
    _impl(1, 16, 16, 256, 2.5, 10),     # 66.5KB effective
    _impl(2, 32, 16, 128, 2.5, 15),     # 66.5KB
    _impl(3, 32, 32, 64, 2.5, 18),      # 66.5KB
    _impl(4, 32, 32, 128, 3.625, 27),   # 131.625KB
    _impl(5, 64, 32, 64, 3.625, 36),    # 131.625KB
]


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    mac_pj: float
    dram_pj: float
    gbuf_pj: float
    reg_pj: float
    reg_static_pj: float

    @property
    def total_pj(self) -> float:
        return (self.mac_pj + self.dram_pj + self.gbuf_pj
                + self.reg_pj + self.reg_static_pj)

    def per_mac(self, macs: int) -> float:
        return self.total_pj / macs


def layer_energy(macs: int, dram_accesses: float, rep: MappingReport,
                 impl: Implementation,
                 core_mhz: float = 500.0) -> EnergyReport:
    """Total energy of a layer on an implementation (Sec. VI-D).

    Static LReg energy: in each cycle at most one of the r LRegs per PE
    is written; the other r-1 leak.  We model static power per idle
    entry-cycle as 1% of a dynamic access — this reproduces the paper's
    observation that large r makes static Reg energy dominate."""
    lr_pj = lreg_pj(impl.lreg_bytes)
    dyn_reg = rep.lreg_writes * lr_pj \
        + (rep.greg_writes + rep.greg_reads) * GREG_PJ
    idle_entries = impl.array.psum_capacity
    static_reg = rep.cycles * idle_entries * lr_pj * 0.01
    return EnergyReport(
        mac_pj=macs * MAC_PJ,
        dram_pj=dram_accesses * DRAM_PJ,
        gbuf_pj=rep.gbuf_total * gbuf_pj(impl.array.gbuf_entries),
        reg_pj=dyn_reg,
        reg_static_pj=static_reg)
