"""Convolutional-layer workload description (paper Sec. II-A, Fig. 1/2).

The port's own copy of ``repro/core/layer.py``: the reference package
is never imported here.

Every quantity the paper's analysis needs is derived here once:
output dims, MAC count, tensor footprints and the sliding-window reuse
factor ``R = Wk*Hk / D**2`` (paper Eq. (2)).

A matmul / FC layer is the ``R == 1`` special case (paper Sec. III-A):
``matmul_layer(M, N, K)`` builds a ConvLayer with 1x1 kernels so every
formula in :mod:`repro_torch.core.lower_bound` degenerates to the classical
Hong-Kung matrix-multiplication bound.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One convolutional layer: B images, Ci->Co channels, HkxWk kernel."""

    name: str
    batch: int          # B
    ci: int             # input channels
    co: int             # output channels
    hi: int             # input rows
    wi: int             # input cols
    hk: int             # kernel rows
    wk: int             # kernel cols
    stride: int = 1     # D
    pad: int = 0

    # ---- derived dimensions -------------------------------------------------
    @property
    def ho(self) -> int:
        return (self.hi + 2 * self.pad - self.hk) // self.stride + 1

    @property
    def wo(self) -> int:
        return (self.wi + 2 * self.pad - self.wk) // self.stride + 1

    @property
    def reuse_r(self) -> float:
        """Max sliding-window reuse of one input, paper Eq. (2)."""
        return max(1.0, (self.wk * self.hk) / float(self.stride ** 2))

    # ---- tensor element counts ---------------------------------------------
    @property
    def n_inputs(self) -> int:
        return self.batch * self.ci * self.hi * self.wi

    @property
    def n_weights(self) -> int:
        return self.co * self.ci * self.hk * self.wk

    @property
    def n_outputs(self) -> int:
        return self.batch * self.co * self.ho * self.wo

    @property
    def macs(self) -> int:
        """Total multiply-accumulates = B*Wo*Ho*Co*Wk*Hk*Ci."""
        return self.n_outputs * self.ci * self.hk * self.wk

    # ---- converted matmul view (paper Fig. 3) -------------------------------
    @property
    def mm_m(self) -> int:
        """Rows of the unfolded input matrix A: B*Ho*Wo."""
        return self.batch * self.ho * self.wo

    @property
    def mm_n(self) -> int:
        """Cols of the weight matrix B: Co."""
        return self.co

    @property
    def mm_k(self) -> int:
        """Contraction depth: Ci*Hk*Wk."""
        return self.ci * self.hk * self.wk

    def halo_extent(self, x: int, y: int) -> tuple[int, int]:
        """Input footprint (x', y') of an x*y output tile (paper Sec. IV-A)."""
        xp = (x - 1) * self.stride + self.wk
        yp = (y - 1) * self.stride + self.hk
        return xp, yp

    def fetched_area(self, x: int, y: int) -> float:
        """Exact per-image-channel input elements fetched from DRAM when
        the output plane is swept by x*y tiles (halo-extended, clipped
        to the real image — zero-padding is never fetched)."""

        def axis_sum(out_dim: int, tile: int, k: int, in_dim: int) -> int:
            total = 0
            d = self.stride
            for start in range(0, out_dim, tile):
                n = min(tile, out_dim - start)
                if d <= k:          # windows overlap: contiguous span
                    lo = start * d - self.pad
                    hi = lo + (n - 1) * d + k
                    total += min(hi, in_dim) - max(lo, 0)
                else:               # disjoint windows: per-window clip
                    for w in range(n):
                        lo = (start + w) * d - self.pad
                        total += min(lo + k, in_dim) - max(lo, 0)
            return total

        return (axis_sum(self.wo, max(1, x), self.wk, self.wi)
                * axis_sum(self.ho, max(1, y), self.hk, self.hi))

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (f"{self.name}: B{self.batch} {self.ci}->{self.co} "
                f"in {self.hi}x{self.wi} k{self.hk}x{self.wk} s{self.stride}")


def matmul_layer(m: int, n: int, k: int, name: str = "matmul") -> ConvLayer:
    """R==1 special case: an MxK @ KxN matmul expressed as a 1x1 conv."""
    return ConvLayer(name=name, batch=1, ci=k, co=n, hi=m, wi=1,
                     hk=1, wk=1, stride=1, pad=0)


def fc_layer(batch: int, n_in: int, n_out: int, name: str = "fc") -> ConvLayer:
    """Fully-connected layer (paper: 'our conclusion with R=1 can be
    applied to FC layers')."""
    return matmul_layer(batch, n_out, n_in, name=name)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def num_tiles(total: int, tile: int) -> int:
    return ceil_div(total, max(1, tile))


def geometric_candidates(limit: int, base: float = 1.25,
                         include: tuple[int, ...] = ()) -> list[int]:
    """Geometric grid of candidate tile sizes in [1, limit].

    Exhaustive integer search is O(limit^4) for the quadruple {b,z,y,x}
    (the paper reports 7.2e13 points for just two loops); a geometric
    grid preserves the optimum within a (1+eps) factor because every
    traffic formula is monotone in each tile size.
    """
    out = {1, int(limit)} | {i for i in include if 1 <= i <= limit}
    v = 1.0
    while v < limit:
        out.add(int(round(v)))
        v *= base
    return sorted(x for x in out if 1 <= x <= limit)


def balanced_candidates(limit: int) -> list[int]:
    """Tile sizes that split [0, limit) into equal-as-possible pieces:
    {ceil(limit/n) : n in 1..limit}.  Every optimum of a ceil-based
    traffic formula lies on this set (shrinking a tile without changing
    the tile count never helps, growing it reduces the count)."""
    return sorted({ceil_div(limit, n) for n in range(1, limit + 1)})
