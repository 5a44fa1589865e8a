"""On-chip workload & storage mapping (paper Sec. IV-B, Figs. 8/9).

The port's copy of ``repro/core/mapping.py``.

Models a p x q PE array executing one iteration of the dataflow:
  * each PE owns an  x_s * y_s * z_s  output sub-block (psums in LRegs),
  * PE rows share inputs / PE columns share weights through GRegs
    (one GReg read broadcasts to a whole p_g x q_g group),
  * a pass = one psum update of every output (x_s*y_s*z_s cycles),
  * an iteration = k*Wk*Hk passes.

Deliverables of this module:
  GBuf traffic   — weights read exactly once (lower bound); inputs read
                   (x'_s*y'_s)/(x_s*y_s) times (the halo factor the
                   paper chooses to pay for regular access patterns).
  Reg traffic    — Eq. (16): one LReg write per MAC (lower bound) plus
                   GReg fills (the paper's "little extra Reg
                   communication").  The psum read feeding the MAC comes
                   from the accumulator forwarding path, so — as in the
                   paper's Fig. 17 accounting — only writes are counted.
  Cycle count    — passes * pass length, plus utilization factors.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.dataflow import OursDataflow, Tiling, Traffic
from repro_torch.core.layer import ConvLayer, balanced_candidates, ceil_div


@dataclasses.dataclass(frozen=True)
class PEArray:
    """Accelerator geometry (paper Table I implementations)."""

    p: int                  # PE rows
    q: int                  # PE cols
    lreg_entries: int       # psum entries per PE (e.g. 128 = 256B @16b)
    greg_entries: int       # total GReg entries
    gbuf_entries: int       # total GBuf entries (IGBuf + WGBuf)
    pg: int = 4             # PE-group rows sharing a GReg set
    qg: int = 4             # PE-group cols

    @property
    def n_pe(self) -> int:
        return self.p * self.q

    @property
    def psum_capacity(self) -> int:
        return self.n_pe * self.lreg_entries

    @property
    def igbuf_entries(self) -> int:
        """IGBuf:WGBuf split ~ 4:1 (paper Sec. V: 2KB / 0.5KB)."""
        return (self.gbuf_entries * 4) // 5

    @property
    def wgbuf_entries(self) -> int:
        return self.gbuf_entries - self.igbuf_entries

    @property
    def effective_s(self) -> int:
        """Effective on-chip memory (Sec. III): psum LRegs + GBufs.

        GRegs hold copies of GBuf data, so they are excluded (the
        effective memory contains no duplicated data)."""
        return self.psum_capacity + self.gbuf_entries


@dataclasses.dataclass(frozen=True)
class MappingReport:
    gbuf_reads_in: float
    gbuf_writes_in: float
    gbuf_reads_w: float
    gbuf_writes_w: float
    lreg_writes: float
    greg_writes: float
    greg_reads: float
    cycles: float
    pe_utilization: float
    lreg_utilization: float

    @property
    def gbuf_total(self) -> float:
        return (self.gbuf_reads_in + self.gbuf_writes_in
                + self.gbuf_reads_w + self.gbuf_writes_w)

    @property
    def reg_total(self) -> float:
        return self.lreg_writes + self.greg_writes + self.greg_reads


def per_pe_tile(t: Tiling, arr: PEArray) -> tuple[int, int, int]:
    """Split the iteration tile b*x*y (rows) x z (cols) over p x q PEs.

    Rows of the reshaped output sub-matrix go to PE rows, columns to PE
    columns (Fig. 8): each PE computes x_s*y_s spatial outputs in z_s
    channels."""
    u = t.b * t.x * t.y
    xs_ys = ceil_div(u, arr.p)          # spatial outputs per PE
    zs = ceil_div(t.z, arr.q)           # channels per PE
    xs = max(1, int(math.sqrt(xs_ys)))
    ys = ceil_div(xs_ys, xs)
    return xs, ys, zs


def map_iteration(layer: ConvLayer, t: Tiling, arr: PEArray,
                  dram: Traffic) -> MappingReport:
    """On-chip traffic for a whole layer executed with tiling ``t``.

    ``dram`` is the layer's DRAM traffic under the same tiling — the
    GBuf write volume equals what is fetched from DRAM (every loaded
    word is written into the GBuf once), establishing the paper's
    GBuf lower-bound relation (Table IV)."""
    xs, ys, zs = per_pe_tile(t, arr)
    xsp, ysp = layer.halo_extent(xs, ys)
    halo = (xsp * ysp) / max(1.0, float(xs * ys))

    # --- GBuf: weights once, inputs once + halos -------------------------
    gbuf_writes_w = dram.reads_w                    # 1.00x (Table IV)
    gbuf_reads_w = dram.reads_w                     # read exactly once
    gbuf_writes_in = dram.reads_in * 1.07           # tile-boundary padding
    gbuf_reads_in = dram.reads_in * halo            # halo factor ~1.67x

    # --- Regs -------------------------------------------------------------
    lreg_writes = float(layer.macs)                 # Eq. (16) lower bound
    # GReg fills: every GBuf read lands in each group's GReg copy once;
    # GReg reads broadcast to a p_g (weights) / q_g (inputs) group.
    greg_writes = (gbuf_reads_in * (arr.p // arr.pg)
                   + gbuf_reads_w * (arr.q // arr.qg))
    greg_reads = float(layer.macs) / arr.qg + float(layer.macs) / arr.pg

    # --- cycles -------------------------------------------------------------
    n_iter = (ceil_div(layer.batch, t.b) * ceil_div(layer.co, t.z)
              * ceil_div(layer.ho, t.y) * ceil_div(layer.wo, t.x)
              * ceil_div(layer.ci, t.k))
    pass_cycles = xs * ys * zs
    cycles = float(n_iter * t.k * layer.hk * layer.wk * pass_cycles)
    ideal_cycles = layer.macs / arr.n_pe
    pe_util = min(1.0, ideal_cycles / max(1.0, cycles))
    lreg_util = min(1.0, (xs * ys * zs) / float(arr.lreg_entries))
    return MappingReport(
        gbuf_reads_in=gbuf_reads_in, gbuf_writes_in=gbuf_writes_in,
        gbuf_reads_w=gbuf_reads_w, gbuf_writes_w=gbuf_writes_w,
        lreg_writes=lreg_writes,
        greg_writes=greg_writes, greg_reads=greg_reads,
        cycles=cycles, pe_utilization=pe_util, lreg_utilization=lreg_util)


def fit_tiling_to_array(layer: ConvLayer, arr: PEArray) -> Tiling:
    """Best iteration tile for a fixed implementation (Table I).

    Unlike the free search (which splits one budget S), a real
    implementation has a *fixed* memory split: psums must fit the LRegs,
    the streamed input slice must fit the IGBuf, z must fit the WGBuf.
    Searches the same candidate space as OursDataflow under those
    per-memory constraints (paper: implementations pay only 3-4% over
    the free dataflow)."""
    df = OursDataflow()
    cands: list[tuple[float, float, Tiling]] = []
    for b in balanced_candidates(layer.batch):
        for y in balanced_candidates(layer.ho):
            for x in balanced_candidates(layer.wo):
                xp, yp = layer.halo_extent(x, y)
                if b * xp * yp > arr.igbuf_entries:
                    continue
                z = min(layer.co, arr.psum_capacity // max(1, b * x * y),
                        arr.wgbuf_entries)
                if z < 1:
                    continue
                z = min(z, ceil_div(layer.co,
                                    ceil_div(layer.co, z)))  # balance
                t = Tiling(b=b, z=z, y=y, x=x, k=1)
                q = df.traffic(layer, t)
                # PE-array fit: fraction of the p x q grid doing useful
                # work when the u x z tile is carved into per-PE blocks
                u = t.b * t.x * t.y
                util = (u / (ceil_div(u, arr.p) * arr.p)) \
                    * (t.z / (ceil_div(t.z, arr.q) * arr.q))
                cands.append((q.total, util, t))
    if not cands:   # tiny IGBuf: fall back to single-row tiles
        return Tiling(b=1, z=min(layer.co, arr.wgbuf_entries),
                      y=1, x=min(layer.wo,
                                 max(1, arr.igbuf_entries
                                     - layer.wk)), k=1).clamp(layer)
    best_traffic = min(c[0] for c in cands)
    # among near-optimal-traffic tilings, take the best PE utilization
    near = [c for c in cands if c[0] <= best_traffic * 1.03]
    return max(near, key=lambda c: c[1])[2]
