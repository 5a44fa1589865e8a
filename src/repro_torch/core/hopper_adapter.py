"""Block geometry for the port: the reference planner's accounting
rules, and the facts of the card the CUDA kernel tiles for.

Two kinds of constants live here and must not be mixed up:

  * **Accountant constants of the reference planner.**  The serve
    ledger charges each request the words of the *reference's*
    accounting plans, so the port plans exactly as
    ``repro/core/tpu_adapter.py`` does, word for word: the same
    default budget (half of a 128 MiB on-chip memory), the same
    128-wide alignment once the budget affords it (``:200``), and the
    same per-word-size row alignment below it.  They describe the
    paper's accounting model, not this card.
  * **Facts of the card** (NVIDIA H100 SXM): SM count, shared memory
    per block and registers per SM, which the CUDA kernel's own CTA
    tiling (:mod:`repro_torch.kernels.conv_lb.kernel`) is sized by,
    and the published peak rates a kernel's ``bound_ms`` is computed
    from.

:func:`hbm_traffic_model` and :func:`arithmetic_intensity` are the
reference's accounting of the matmul (``tpu_adapter.py:270-288``),
word for word.

Maps {S, u, z, k} of the paper onto a batch-folded conv block
(:class:`ConvBlockShape`): u = b*y*x psum rows, z = co channels
resident, k = ci slice streamed per pass, with halos for WndR.

:class:`ShardPlan` and :func:`balanced_shard_plan`, the mesh-level
communication balance, are the reference's (``tpu_adapter.py:289-315``)
word for word.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.layer import balanced_candidates, geometric_candidates
from repro_torch.core.lower_bound import fold_u, optimal_block

# --- accountant constants of the reference planner ---------------------------
#: on-chip words budget of the reference planner (bytes); plans default
#: to half of it, exactly as the reference does
REF_ONCHIP_BYTES = 128 * 1024 * 1024
REF_PLAN_BUDGET = REF_ONCHIP_BYTES // 2
#: block alignment once the budget affords 128-wide blocks
REF_ALIGN = 128
#: budget from which REF_ALIGN applies (below it: REF_ROW_ALIGN)
REF_ALIGN_MIN_BUDGET = 8 * 1024 * 1024
#: word size (bytes) -> row alignment at small (paper-scale) budgets
REF_ROW_ALIGN = {1: 32, 2: 16, 4: 8}

# --- facts of the card (NVIDIA H100 SXM) ----------------------------------------
SM_COUNT = 132
SMEM_PER_BLOCK = 232_448          # bytes, dynamic, after opt-in above 48 KB
REGS_PER_SM = 65_536
#: registers a thread may hold, and the unit a thread's count is
#: allocated in
REGS_PER_THREAD_MAX = 255
REG_ALLOC_UNIT = 8
#: a launch's grid: blocks along x, and along y or z
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65_535
#: a TMA tensor map: a box's extent in any dimension, a traversal
#: stride, and the alignment (bytes) of its base and global strides
TMA_BOX_MAX = 256
TMA_ELEM_STRIDE_MAX = 8
TMA_ALIGN = 16
#: published dense peaks at the 700 W limit
PEAK_F32_FLOPS = 67e12            # f32 FMA outside the tensor cores
PEAK_BF16_FLOPS = 989e12          # bf16 on the tensor cores, dense
PEAK_TF32_FLOPS = 495e12          # TF32 on the tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
#: published H100 SXM figures: NVLink 4's 900 GB/s a card, 450 GB/s in
#: each direction, and 80 GB of HBM3
NVLINK_BYTES_PER_S = 450e9
HBM_BYTES = 80e9


def launch_bounds_regs(threads: int, min_blocks: int = 1) -> int:
    """The registers a thread may hold under ``__launch_bounds__(threads,
    min_blocks)``: ``min_blocks`` CTAs of ``threads`` in one SM's
    registers, rounded down to the allocation unit, at most
    ``REGS_PER_THREAD_MAX``."""
    regs = REGS_PER_SM // (threads * max(1, min_blocks))
    return min(REGS_PER_THREAD_MAX, regs - regs % REG_ALLOC_UNIT)


def row_align_for(dtype_bytes: int) -> int:
    """Reference row alignment for a word size; unknown sizes take the
    1-byte (deepest) alignment, as the reference does."""
    return REF_ROW_ALIGN.get(dtype_bytes, REF_ROW_ALIGN[1])


def round_to(v: int, mult: int) -> int:
    return max(mult, (v // mult) * mult)


def round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


@dataclasses.dataclass(frozen=True)
class BlockShape:
    """Matmul block geometry of the converted-matmul view."""

    bm: int   # output rows per block   (paper: u)
    bn: int   # output cols per block   (paper: z)
    bk: int   # reduction slice         (paper: k)

    @property
    def psum_bytes(self) -> int:
        return self.bm * self.bn * 4          # f32 accumulator

    def operand_bytes(self, dtype_bytes: int = 2) -> int:
        return (self.bm * self.bk + self.bk * self.bn) * dtype_bytes

    def vmem_bytes(self, dtype_bytes: int = 2) -> int:
        # double-buffered operands + resident psums
        return self.psum_bytes + 2 * self.operand_bytes(dtype_bytes)


def lb_block_shape(m: int, n: int, k: int, *,
                   r: float = 1.0,
                   dtype_bytes: int = 2,
                   vmem_budget: int = REF_PLAN_BUDGET,
                   bk: int | None = None,
                   align: int = REF_ALIGN) -> BlockShape:
    """Choose {bm, bn, bk} from the paper's lower-bound conditions:
    seeded by :func:`~repro_torch.core.lower_bound.optimal_block`
    (u = R*z, u*z = S on the f32 psum budget), aligned, then shrunk
    until psums plus double-buffered operand panels fit the budget."""
    if bk is None:
        bk = min(round_up(min(k, 512), align), round_up(k, align))
    tiles = optimal_block(max(align * align, vmem_budget // 4), r)
    bm = min(round_up(tiles.u, align), round_up(m, align))
    bn = min(round_up(tiles.z, align), round_up(n, align))
    # shrink toward bm ~= r*bn until the working set fits
    while BlockShape(bm, bn, bk).vmem_bytes(dtype_bytes) > vmem_budget \
            and (bm > align or bn > align):
        if bm > max(align, round_to(int(r * bn), align)):
            bm -= align
        elif bn > align and round_to(int(r * (bn - align)), align) \
                >= bm - align:
            bn -= align
            bm = max(align, min(bm, round_to(int(r * bn), align)))
        else:
            bm = max(align, bm - align)
            bn = max(align, bn - align)
    return BlockShape(bm=max(align, bm), bn=max(align, bn), bk=bk)


@dataclasses.dataclass(frozen=True)
class ConvBlockShape:
    """Conv block geometry: the paper's {u, z, k} in conv space.

    u = b*y*x batch-folded psum tile, z = co channels resident, k = ci
    slice streamed per pass; (halo_y, halo_x) is the halo-extended
    input footprint of one (y, x) output tile."""

    y: int
    x: int
    co: int
    ci: int
    halo_y: int
    halo_x: int
    b: int = 1

    @property
    def u(self) -> int:
        return self.b * self.y * self.x

    @property
    def psum_bytes(self) -> int:
        return self.u * self.co * 4               # f32 accumulator

    def operand_bytes(self, hk: int, wk: int, dtype_bytes: int = 4) -> int:
        return (self.b * self.halo_y * self.halo_x * self.ci
                + hk * wk * self.ci * self.co) * dtype_bytes

    def vmem_bytes(self, hk: int, wk: int, dtype_bytes: int = 4,
                   w_pinned: bool = False, residual: bool = False) -> int:
        # double-buffered streamed panels + resident psums; a weight
        # block constant over the whole grid (sole Ci and Co block) is
        # counted once; a fused residual join streams one more
        # double-buffered u x co operand tile
        in_buf = 2 * self.b * self.halo_y * self.halo_x * self.ci
        w_buf = (1 if w_pinned else 2) * hk * wk * self.ci * self.co
        r_buf = 2 * self.u * self.co if residual else 0
        return self.psum_bytes + (in_buf + w_buf + r_buf) * dtype_bytes

    def footprint_elems(self, hk: int, wk: int,
                        residual: bool = False) -> int:
        """On-chip words S of the paper's model (no double buffering).
        A fused residual join holds one more u x co operand tile."""
        return (self.u * self.co * (2 if residual else 1)
                + self.b * self.halo_y * self.halo_x * self.ci
                + hk * wk * self.ci * self.co)


def balanced_tile(dim: int, t: int) -> int:
    """Largest tile <= t splitting dim into equal ceil pieces."""
    return -(-dim // -(-dim // max(1, t)))


def conv_lb_block_shape(ho: int, wo: int, ci: int, co: int,
                        hk: int, wk: int, *,
                        batch: int = 1,
                        stride: tuple[int, int] = (1, 1),
                        dilation: tuple[int, int] = (1, 1),
                        dtype_bytes: int = 4,
                        vmem_budget: int = REF_PLAN_BUDGET
                        ) -> ConvBlockShape:
    """Spatially-tiled conv blocks from the paper's two key conditions
    on the converted-matmul view (M = B*Ho*Wo, N = Co, K = Ci, R =
    Hk*Wk/(sy*sx)), unfolded into a batch-folded (b, y, x) tile and
    shrunk until the halo-extended working set fits."""
    sy, sx = stride
    r = max(1.0, (hk * wk) / float(sy * sx))
    # the reference's alignment rule: 128-wide blocks only once the
    # budget affords them, the word size's row alignment below that
    align = (REF_ALIGN if vmem_budget >= REF_ALIGN_MIN_BUDGET
             else row_align_for(dtype_bytes))
    blk = lb_block_shape(batch * ho * wo, co, ci, r=r,
                         dtype_bytes=dtype_bytes,
                         vmem_budget=vmem_budget, align=align,
                         bk=min(round_up(ci, align), align))
    co_b = max(1, min(co, blk.bn))
    ci_b = max(1, min(ci, blk.bk))
    u = max(1, min(blk.bm, batch * ho * wo))
    tb, ty, tx = fold_u(u, batch, ho, wo)
    ty = balanced_tile(ho, ty)
    tx = balanced_tile(wo, tx)
    tb = balanced_tile(batch, tb)

    def mk(tb, ty, tx, co_b, ci_b):
        yp = (ty - 1) * sy + (hk - 1) * dilation[0] + 1
        xp = (tx - 1) * sx + (wk - 1) * dilation[1] + 1
        return ConvBlockShape(y=ty, x=tx, co=co_b, ci=ci_b,
                              halo_y=yp, halo_x=xp, b=tb)

    cand = mk(tb, ty, tx, co_b, ci_b)
    # shrink (largest-first) the dims that only cost memory until the
    # real working set fits
    while cand.vmem_bytes(hk, wk, dtype_bytes) > vmem_budget:
        if ci_b > 8:
            ci_b = max(8, ci_b // 2)
        elif tb > 1:
            tb = tb // 2
        elif ty * tx > 64 and ty >= tx:
            ty = max(1, ty // 2)
        elif ty * tx > 64:
            tx = max(1, tx // 2)
        elif co_b > 8:
            co_b = max(8, co_b // 2)
        elif ty * tx > 1:
            ty, tx = max(1, ty // 2), max(1, tx // 2)
        elif ci_b > 1 or co_b > 1:
            ci_b, co_b = max(1, ci_b // 2), max(1, co_b // 2)
        else:
            break
        cand = mk(tb, ty, tx, co_b, ci_b)
    return mk(balanced_tile(batch, tb), balanced_tile(ho, ty),
              balanced_tile(wo, tx), balanced_tile(co, co_b),
              balanced_tile(ci, ci_b))


def hbm_traffic_model(m: int, n: int, k: int, blk: BlockShape,
                      dtype_bytes: int = 2) -> float:
    """Eq. (14) with R = 1 for the matmul's accounted blocks: bytes
    moved.  Per bm x bn output block the A-panel bm*k and the B-panel
    k*bn are read once; C is written once."""
    nblocks_m = -(-m // blk.bm)
    nblocks_n = -(-n // blk.bn)
    reads = nblocks_n * (m * k) + nblocks_m * (k * n)
    writes = m * n
    return float((reads + writes) * dtype_bytes)


def arithmetic_intensity(m: int, n: int, k: int, blk: BlockShape,
                         dtype_bytes: int = 2) -> float:
    """FLOP per accounted byte of :func:`hbm_traffic_model`."""
    flops = 2.0 * m * n * k
    return flops / hbm_traffic_model(m, n, k, blk, dtype_bytes)


def conv_block_candidates(batch: int, ho: int, wo: int, ci: int
                          ) -> "itertools.product":
    """Candidate (b, y, x, ci_b) tuples for the plan autotuner: a
    geometric subsample of the balanced-split sets."""
    def cands(dim: int, base: float) -> list[int]:
        bal = balanced_candidates(dim)
        geo = set(geometric_candidates(dim, base=base, include=(dim,)))
        return [c for c in bal if c in geo] or bal

    return itertools.product(cands(batch, 1.6), cands(ho, 2.0),
                             cands(wo, 2.0), cands(ci, 2.0))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Mesh-level communication balance (beyond-paper, DESIGN.md §5)."""

    m_shards: int
    n_shards: int

    def per_chip_tile(self, m: int, n: int) -> tuple[int, int]:
        return -(-m // self.m_shards), -(-n // self.n_shards)


def balanced_shard_plan(m: int, n: int, chips: int,
                        r: float = 1.0) -> ShardPlan:
    """Apply u ~= R*z at the mesh level: per-chip output tile as square
    as R allows, which minimizes the all-gather volume of the two
    operand panels (the interconnect analogue of Eq. (14))."""
    best, best_cost = None, None
    for mshard in range(1, chips + 1):
        if chips % mshard:
            continue
        nshard = chips // mshard
        pm, pn = -(-m // mshard), -(-n // nshard)
        # per-chip panel traffic ~ pm*K + K*pn ;  minimized when pm ~= r*pn
        cost = pm / r + pn
        if best_cost is None or cost < best_cost:
            best, best_cost = ShardPlan(mshard, nshard), cost
    return best
