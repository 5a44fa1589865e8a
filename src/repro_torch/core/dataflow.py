"""Dataflow zoo + tiling search (paper Sec. IV-A, Fig. 12/13).

The port's copy of ``repro/core/dataflow.py``.

Each dataflow is a stationarity scheme: one tensor block is pinned
on-chip ("resides on chip for reuse" in the paper's words) while the
others stream.  ``traffic()`` gives the exact DRAM access volume for a
tiling; ``search()`` optimizes the tiling under an effective on-chip
memory budget ``S`` — mirroring the paper's methodology ("the tiling
sizes of all dataflows are obtained by exhaustive searches").  Because
every traffic formula here is monotone in the resident-block dimension
that only consumes memory (z for psum-stationary schemes, k for the
spill-between-k-tiles schemes), that dimension is solved analytically
and the remaining 2-3 dimensions are swept on a fine geometric grid —
same optimum, orders of magnitude fewer points than the paper's 7.2e13.

Zoo (Fig. 12):
  ours    — Eq. (14): psum-stationary u x z output block, u=b*x*y ~ R*z,
            balanced InR/WtR, k=1 reduction streaming, WndR via halos.
  InR-A   — a  b x k x y' x x'  input block resides; weights stream;
            psums spill to DRAM between k-tiles.
  InR-B   — full-depth input block (k=Ci); psums finish on chip; all
            kernels re-streamed per spatial block.
  WtR-A   — a  z x k x Wk x Hk  weight block resides; inputs stream per
            z-tile; psums spill between k-tiles.
  WtR-B   — full-depth weight block (k=Ci); psums finish on chip;
            inputs re-streamed per z-tile.
  OutR-A  — ShiDianNao-style: all Co channels of a spatial output tile
            reside (z=Co); inputs/weights stream.
  OutR-B  — full-row output tile (x=Wo), channel/row-tiled.

All volumes in elements.  ``found_minimum`` reproduces the paper's
"Found minimum" curve (best dataflow with best tiling per layer).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Sequence

from repro_torch.core.layer import (ConvLayer, balanced_candidates,
                              geometric_candidates, num_tiles)


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Tile quadruple {b, z, y, x} + reduction slice k (paper Fig. 7)."""

    b: int = 1
    z: int = 1
    y: int = 1
    x: int = 1
    k: int = 1

    def clamp(self, layer: ConvLayer) -> "Tiling":
        return Tiling(b=min(self.b, layer.batch), z=min(self.z, layer.co),
                      y=min(self.y, layer.ho), x=min(self.x, layer.wo),
                      k=min(self.k, layer.ci))


@dataclasses.dataclass(frozen=True)
class Traffic:
    """DRAM access volume split by tensor (elements)."""

    reads_in: float
    reads_w: float
    reads_out: float   # psum re-reads (0 when psums never spill)
    writes_out: float

    @property
    def total(self) -> float:
        return self.reads_in + self.reads_w + self.reads_out + self.writes_out

    @property
    def reads(self) -> float:
        return self.reads_in + self.reads_w + self.reads_out

    def __add__(self, other: "Traffic") -> "Traffic":
        return Traffic(self.reads_in + other.reads_in,
                       self.reads_w + other.reads_w,
                       self.reads_out + other.reads_out,
                       self.writes_out + other.writes_out)


ZERO_TRAFFIC = Traffic(0.0, 0.0, 0.0, 0.0)


def _grid(limit: int, fine: bool = True) -> list[int]:
    """Balanced-split candidates; geometric subsample for huge dims."""
    cands = balanced_candidates(limit)
    if len(cands) > 96:
        keep = set(geometric_candidates(limit, base=1.05, include=(limit,)))
        cands = [c for c in cands if c in keep] or cands[:96]
    return cands


class Dataflow:
    """Base class: a loop order/stationarity scheme with tunable tiling."""

    name: str = "base"

    def footprint(self, layer: ConvLayer, t: Tiling) -> int:
        """Effective on-chip memory needed (elements) — no duplicates."""
        raise NotImplementedError

    def traffic(self, layer: ConvLayer, t: Tiling) -> Traffic:
        raise NotImplementedError

    def candidates(self, layer: ConvLayer, s: int) -> Iterable[Tiling]:
        """Feasible tilings (already memory-checked where analytic)."""
        raise NotImplementedError

    def search(self, layer: ConvLayer, s: int) -> tuple[Tiling, Traffic]:
        """Best tiling under footprint <= s (paper's exhaustive search)."""
        best_t, best_q = None, None
        for t in self.candidates(layer, s):
            t = t.clamp(layer)
            if self.footprint(layer, t) > s:
                continue
            q = self.traffic(layer, t)
            if best_q is None or q.total < best_q.total:
                best_t, best_q = t, q
        if best_t is None:  # S too small for this scheme: minimal tiling
            best_t = Tiling().clamp(layer)
            best_q = self.traffic(layer, best_t)
        return best_t, best_q


def _spatial_blocks(layer: ConvLayer, t: Tiling) -> int:
    return (num_tiles(layer.batch, t.b) * num_tiles(layer.ho, t.y)
            * num_tiles(layer.wo, t.x))


class OursDataflow(Dataflow):
    """Paper Sec. IV-A / Eq. (14): psum-stationary balanced dataflow.

    For every b*x*y*z output block: read z kernels (Wk*Hk*Ci*z) and the
    halo-extended input block (b*x'*y'*Ci) exactly once; write outputs
    once; stream k=1 input channels so the GBuf stays tiny.
    """

    name = "ours"

    def footprint(self, layer: ConvLayer, t: Tiling) -> int:
        xp, yp = layer.halo_extent(t.x, t.y)
        psums = t.b * t.x * t.y * t.z
        igbuf = t.b * xp * yp * t.k          # one k-slice of inputs
        wgbuf = layer.hk * layer.wk * t.k * t.z
        return psums + igbuf + wgbuf

    def traffic(self, layer: ConvLayer, t: Tiling) -> Traffic:
        nz = num_tiles(layer.co, t.z)
        nsp = _spatial_blocks(layer, t)
        # weights: z-tiles jointly cover Co exactly (partial last tile)
        reads_w = nsp * layer.hk * layer.wk * layer.ci * layer.co
        # inputs: every image fetched once per z-tile, halo-extended and
        # clipped to the real image (padding is never fetched)
        reads_in = (nz * layer.batch * layer.ci
                    * layer.fetched_area(t.x, t.y))
        return Traffic(reads_in=float(reads_in), reads_w=float(reads_w),
                       reads_out=0.0, writes_out=float(layer.n_outputs))

    def _z_max(self, layer: ConvLayer, t: Tiling, s: int) -> int:
        """Largest z fitting the budget for a given spatial tile.

        Weight traffic is z-independent (Nz*z ~ Co) and input traffic
        strictly decreases with z, so z = z_max is optimal."""
        xp, yp = layer.halo_extent(t.x, t.y)
        free = s - t.b * xp * yp * t.k
        denom = t.b * t.x * t.y + layer.hk * layer.wk * t.k
        return max(0, free // max(1, denom))

    def candidates(self, layer: ConvLayer, s: int) -> Iterable[Tiling]:
        for b, y, x in itertools.product(_grid(layer.batch),
                                         _grid(layer.ho),
                                         _grid(layer.wo)):
            t = Tiling(b=b, z=1, y=y, x=x, k=1)
            z = self._z_max(layer, t, s)
            if z >= 1:
                yield Tiling(b=b, z=min(z, layer.co), y=y, x=x, k=1)
        seed = self.optimal_tiling(layer, s)
        if self.footprint(layer, seed) <= s:
            yield seed

    def optimal_tiling(self, layer: ConvLayer, s: int) -> Tiling:
        """Closed-form seed from the two key conditions (Sec. IV-C):
        b*x*y ~= R*z and b*x*y*z ~= S."""
        from repro_torch.core.lower_bound import fold_u

        r = layer.reuse_r
        z = max(1, min(layer.co, int(math.sqrt(s / r))))
        u = max(1, s // max(1, z))
        b, y, x = fold_u(u, layer.batch, layer.ho, layer.wo)
        t = Tiling(b=b, z=z, y=y, x=x, k=1).clamp(layer)
        # shrink z until the halo'd footprint fits
        while t.z > 1 and self.footprint(layer, t) > s:
            t = dataclasses.replace(t, z=t.z - max(1, t.z // 8))
        return t


class _InputStationary(Dataflow):
    """InR: a b x k x y' x x' input block resides on chip."""

    def __init__(self, full_depth: bool):
        self.full_depth = full_depth
        self.name = "InR-B" if full_depth else "InR-A"

    def footprint(self, layer: ConvLayer, t: Tiling) -> int:
        xp, yp = layer.halo_extent(t.x, t.y)
        k = layer.ci if self.full_depth else t.k
        resident = t.b * k * xp * yp
        if self.full_depth:
            # z=1 psum slice finishes on chip + one kernel column
            stream = t.b * t.x * t.y + layer.hk * layer.wk * layer.ci
        else:
            # stream one kernel slice + one psum slice
            stream = layer.hk * layer.wk * k + t.b * t.x * t.y
        return resident + stream

    def traffic(self, layer: ConvLayer, t: Tiling) -> Traffic:
        nsp = _spatial_blocks(layer, t)
        area = layer.fetched_area(t.x, t.y)
        if self.full_depth:
            reads_in = layer.batch * layer.ci * area
            reads_w = nsp * layer.n_weights        # all kernels per block
            return Traffic(float(reads_in), float(reads_w), 0.0,
                           float(layer.n_outputs))
        nk = num_tiles(layer.ci, t.k)
        reads_in = layer.batch * layer.ci * area   # resident: once overall
        reads_w = nsp * layer.hk * layer.wk * layer.ci * layer.co
        # psums spill between k-tiles ("shuffled on and off chip")
        writes_out = layer.n_outputs * nk
        reads_out = layer.n_outputs * max(0, nk - 1)
        return Traffic(float(reads_in), float(reads_w),
                       float(reads_out), float(writes_out))

    def _k_max(self, layer: ConvLayer, t: Tiling, s: int) -> int:
        """Spill traffic falls with k, so take the largest k fitting."""
        xp, yp = layer.halo_extent(t.x, t.y)
        free = s - t.b * t.x * t.y
        denom = t.b * xp * yp + layer.hk * layer.wk
        return max(0, free // max(1, denom))

    def candidates(self, layer: ConvLayer, s: int) -> Iterable[Tiling]:
        for b, y, x in itertools.product(_grid(layer.batch),
                                         _grid(layer.ho),
                                         _grid(layer.wo)):
            if self.full_depth:
                yield Tiling(b=b, z=1, y=y, x=x, k=layer.ci)
            else:
                t = Tiling(b=b, z=1, y=y, x=x, k=1)
                k = self._k_max(layer, t, s)
                if k >= 1:
                    yield Tiling(b=b, z=1, y=y, x=x, k=min(k, layer.ci))


class _WeightStationary(Dataflow):
    """WtR: a z x k x Wk x Hk weight block resides on chip."""

    def __init__(self, full_depth: bool):
        self.full_depth = full_depth
        self.name = "WtR-B" if full_depth else "WtR-A"

    def footprint(self, layer: ConvLayer, t: Tiling) -> int:
        k = layer.ci if self.full_depth else t.k
        resident = layer.hk * layer.wk * k * t.z
        # streaming buffers: one input window column + one psum row
        stream = k * layer.hk * layer.wk + t.z
        return resident + stream

    def traffic(self, layer: ConvLayer, t: Tiling) -> Traffic:
        nz = num_tiles(layer.co, t.z)
        reads_w = float(layer.n_weights)            # resident: read once
        reads_in = nz * float(layer.n_inputs)       # re-streamed per z-tile
        if self.full_depth:
            return Traffic(reads_in, reads_w, 0.0, float(layer.n_outputs))
        nk = num_tiles(layer.ci, t.k)
        writes_out = layer.n_outputs * nk
        reads_out = layer.n_outputs * max(0, nk - 1)
        return Traffic(reads_in, reads_w, float(reads_out),
                       float(writes_out))

    def candidates(self, layer: ConvLayer, s: int) -> Iterable[Tiling]:
        kk = layer.hk * layer.wk
        if self.full_depth:
            z = max(1, (s - layer.ci * kk) // max(1, layer.ci * kk + 1))
            if z >= 1:
                yield Tiling(b=1, z=min(z, layer.co), y=1, x=1, k=layer.ci)
        else:
            for z in _grid(layer.co):
                k = max(0, (s - z) // max(1, kk * (z + 1)))
                if k >= 1:
                    yield Tiling(b=1, z=z, y=1, x=1, k=min(k, layer.ci))


class _OutputStationary(Dataflow):
    """OutR with a constrained tile shape (unbalanced, unlike ours)."""

    def __init__(self, full_channels: bool):
        # A: all Co channels of a spatial tile (ShiDianNao);
        # B: full output rows (x=Wo), row/channel-tiled.
        self.full_channels = full_channels
        self.name = "OutR-A" if full_channels else "OutR-B"

    footprint = OursDataflow.footprint
    traffic = OursDataflow.traffic
    _z_max = OursDataflow._z_max

    def candidates(self, layer: ConvLayer, s: int) -> Iterable[Tiling]:
        if self.full_channels:
            for b, y, x in itertools.product(_grid(layer.batch),
                                             _grid(layer.ho),
                                             _grid(layer.wo)):
                yield Tiling(b=b, z=layer.co, y=y, x=x, k=1)
        else:
            for b, y in itertools.product(_grid(layer.batch),
                                          _grid(layer.ho)):
                t = Tiling(b=b, z=1, y=y, x=layer.wo, k=1)
                z = self._z_max(layer, t, s)
                if z >= 1:
                    yield Tiling(b=b, z=min(z, layer.co), y=y,
                                 x=layer.wo, k=1)


def dataflow_zoo() -> list[Dataflow]:
    return [OursDataflow(),
            _InputStationary(full_depth=False),
            _InputStationary(full_depth=True),
            _WeightStationary(full_depth=False),
            _WeightStationary(full_depth=True),
            _OutputStationary(full_channels=True),
            _OutputStationary(full_channels=False)]


def found_minimum(layer: ConvLayer, s: int) -> tuple[str, Tiling, Traffic]:
    """Paper's 'Found minimum': best dataflow with best tiling."""
    best = None
    for df in dataflow_zoo():
        t, q = df.search(layer, s)
        if best is None or q.total < best[2].total:
            best = (df.name, t, q)
    return best


def network_traffic(layers: Sequence[ConvLayer], s: int,
                    dataflow: Dataflow) -> Traffic:
    """Sum of per-layer best-tiling traffic for a whole network."""
    total = ZERO_TRAFFIC
    for layer in layers:
        _, q = dataflow.search(layer, s)
        total = total + q
    return total
