"""Planner, traffic accountant and the forward op of the
paper-dataflow conv — the port's copy of
``repro/kernels/conv_lb/ops.py`` for the serving path.

Two halves, kept apart on purpose:

  * **Accounting.**  :func:`plan_conv` (LRU-cached) resolves the
    reference planner's batch-folded ``(b, y, x, ci, co)`` blocks —
    the paper's closed form seeds a traffic-guided autotuner
    (:func:`autotune_conv_blocks`) — and :meth:`ConvPlan.traffic`
    counts the words those blocks move under the reference's refetch
    rule: a block is fetched again only when its index changes between
    consecutive steps of the grid (nb, ny, nx, nco, nci), nci
    innermost.  The serve ledger charges these plans, so they equal the
    reference's word for word.
  * **Execution.**  :func:`conv2d_lb` runs the conv, group by group,
    through :func:`repro_torch.kernels.conv_lb.kernel.conv_lb`: the
    hand-written CUDA kernel on a CUDA tensor, its plain PyTorch
    version on a CPU tensor.  The kernel tiles for the card, not for
    the accounting plan; what it moves on the card is a measurement of
    its own, not a change to the ledger.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from math import gcd as _gcd

import torch

from repro_torch.analysis.plan_check import (Diagnostic, PlanLegalityError,
                                             check_conv_plan, errors)
from repro_torch.core.dataflow import Traffic
from repro_torch.core.hopper_adapter import (REF_PLAN_BUDGET,
                                             ConvBlockShape, balanced_tile,
                                             conv_block_candidates,
                                             conv_lb_block_shape, round_up)
from repro_torch.core.layer import ceil_div
from repro_torch.core.lower_bound import q_dram_practical
from repro_torch.kernels.conv_lb.kernel import conv_lb
from repro_torch.obs.tracer import active_tracer


def _pair(v) -> tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def compact_halo(halo: int, ld: int, pad: int) -> int:
    """Compact rows fetched per tile on one lhs-dilated axis: the
    ``ceil``-shrunk image of a ``halo``-row dilated window, phase-
    shifted by the conv padding (``ceil(pad/ld)`` leading zero-rows)."""
    if ld == 1:
        return halo
    return ceil_div(pad, ld) + max(1, ceil_div(halo - pad, ld))


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Accounting geometry of one planned conv (one group): blocks,
    padded extents and the true layer the plan was planned for."""

    blocks: ConvBlockShape
    ho: int            # true output dims
    wo: int
    ho_pad: int        # tile-aligned output dims
    wo_pad: int
    hp_pad: int        # input dims after conv + halo padding
    wp_pad: int
    ci_pad: int
    co_pad: int
    stride: tuple[int, int]
    dilation: tuple[int, int]
    hk: int            # kernel extent
    wk: int
    pool: int = 1      # fused epilogue max-pool window (1 = none)
    # lhs (input) dilation: the plan walks the compact plane while
    # h/hp_pad stay in dilated coordinates
    lhs_dilation: tuple[int, int] = (1, 1)
    h: int = 0         # input plane entering the conv
    w: int = 0
    ci: int = 0        # per-group channel counts
    co: int = 0
    py: int = 0        # conv padding
    px: int = 0
    # a residual join lands on this conv's output: one pre-pool
    # output-shaped read per psum tile, and the join's mandatory read
    # on the bound side
    residual: bool = False

    @property
    def lhs_dilated(self) -> bool:
        return self.lhs_dilation != (1, 1)

    def traffic(self, batch: int) -> Traffic:
        """Words this plan moves for one group at ``batch`` images."""
        return _blocks_traffic(batch, self.blocks, self.hk, self.wk,
                               self.ho, self.wo, self.ci_pad,
                               self.co_pad, self.pool,
                               residual=self.residual,
                               lhs_dilation=self.lhs_dilation,
                               pad=(self.py, self.px))

    def traffic_bytes(self, batch: int, dtype_bytes: int = 4) -> float:
        return self.traffic(batch).total * dtype_bytes

    def footprint_elems(self) -> int:
        """Realized on-chip words S the Eq. (15) comparisons use."""
        return self.blocks.footprint_elems(self.hk, self.wk,
                                           residual=self.residual)

    def bound_words(self, layer) -> float:
        """Eq. (15) at the realized footprint, plus the residual join's
        mandatory once-per-word read when the plan fuses one."""
        q = q_dram_practical(layer, self.footprint_elems())
        if self.residual:
            q += float(layer.n_outputs)
        return q


def _blocks_traffic(batch: int, blk: ConvBlockShape, hk: int, wk: int,
                    ho: int, wo: int, ci: int, co: int,
                    pool: int = 1, residual: bool = False,
                    lhs_dilation: tuple[int, int] = (1, 1),
                    pad: tuple[int, int] = (0, 0)) -> Traffic:
    """Words moved by the planned blocks for one group.

    Per grid step the halo'd input tile and the weight slice are each
    fetched once — except that a sole Ci block lets the input tile
    persist across the whole Co sweep, and a sole (Ci, Co) block pins
    the weights for the entire run.  The weight slice is fetched once
    per u x z block whatever blk.b is (the batch-reuse term).  Outputs
    flush once per (bi, yi, xi, coi), pooled when the pool is fused.
    An lhs-dilated plan fetches the compact plane.  The bias row's
    fetches are not counted (vanishing next to any operand panel)."""
    ho_pad, wo_pad = round_up(ho, blk.y), round_up(wo, blk.x)
    ci_pad, co_pad = round_up(ci, blk.ci), round_up(co, blk.co)
    tb = max(1, min(blk.b, batch))
    nb = ceil_div(batch, tb)
    ny, nx = ho_pad // blk.y, wo_pad // blk.x
    nco, nci = co_pad // blk.co, ci_pad // blk.ci
    steps = nb * ny * nx * nco * nci
    in_fetches = steps if nci > 1 else nb * ny * nx
    w_fetches = steps if nco * nci > 1 else 1
    fetch_y, fetch_x = blk.halo_y, blk.halo_x
    if lhs_dilation != (1, 1):
        fetch_y = compact_halo(blk.halo_y, lhs_dilation[0], pad[0])
        fetch_x = compact_halo(blk.halo_x, lhs_dilation[1], pad[1])
    reads_in = in_fetches * tb * fetch_y * fetch_x * blk.ci
    reads_w = w_fetches * hk * wk * blk.ci * blk.co
    if residual:
        # the join operand is streamed once per (bi, yi, xi, coi)
        reads_in += nb * tb * ho_pad * wo_pad * co_pad
    writes = nb * tb * (ho_pad // pool) * (wo_pad // pool) * co_pad
    return Traffic(reads_in=float(reads_in), reads_w=float(reads_w),
                   reads_out=0.0, writes_out=float(writes))


def _snap_pool(t: int, dim: int, pool: int) -> int:
    """Round a tile up to a pool multiple (pool windows never straddle
    tiles)."""
    return min(dim, round_up(t, pool)) if pool > 1 else t


# Extra score charge per weight word moved, on top of its 1x share of
# the total: at serving scale the weights are the recurring term, so
# the planner buys weight reuse with activation traffic whenever the
# exchange is better than 1:2.
W_READ_BIAS = 2.0


def conv_plan_score(t: Traffic) -> float:
    """The autotuner's serving-oriented traffic score (lower=better)."""
    return t.total + W_READ_BIAS * t.reads_w


def autotune_conv_blocks(batch: int, ho: int, wo: int, ci: int, co: int,
                         hk: int, wk: int, *,
                         stride: tuple[int, int],
                         dilation: tuple[int, int],
                         lhs_dilation: tuple[int, int] = (1, 1),
                         pad: tuple[int, int] = (0, 0),
                         pool: int = 1, residual: bool = False,
                         dtype_bytes: int = 4,
                         vmem_budget: int,
                         seed: ConvBlockShape) -> ConvBlockShape:
    """Traffic-guided plan autotuner: enumerate balanced candidate
    ``(b, y, x, ci_b)`` shapes, solve the largest ``co_b`` that fits
    the budget, add the fully weight-pinned candidate when it fits,
    and keep whichever :func:`conv_plan_score` rates cheapest.  The
    closed-form ``seed`` is always a candidate (its ``co_b`` first
    shrunk until a fused join's buffer fits too)."""
    sy, sx = stride
    dy, dx = dilation
    ldy, ldx = lhs_dilation
    db = dtype_bytes
    kk = hk * wk

    def snap_lhs(v: int, dim: int, s: int, ld: int) -> int:
        """Round a tile up so its input offset (v*stride) lands on the
        lhs-dilation phase — every compact fetch starts on a real row."""
        if ld == 1 or (v * s) % ld == 0:
            return v
        step = ld // _gcd(ld, s)
        return min(round_up(v, step), round_up(dim, step))

    def traffic(blk: ConvBlockShape) -> Traffic:
        return _blocks_traffic(batch, blk, hk, wk, ho, wo, ci, co, pool,
                               residual=residual,
                               lhs_dilation=lhs_dilation, pad=pad)

    def fits(blk: ConvBlockShape) -> bool:
        pinned = blk.ci >= ci and blk.co >= co
        return blk.vmem_bytes(hk, wk, db, w_pinned=pinned,
                              residual=residual) <= vmem_budget

    while residual and not fits(seed) and seed.co > 1:
        shrunk = balanced_tile(co, seed.co // 2)
        if not shrunk:
            break
        seed = dataclasses.replace(seed, co=shrunk)

    cands = []
    if fits(seed):
        cands.append((traffic(seed), seed))
    seen = set()
    for b, y, x, cib in conv_block_candidates(batch, ho, wo, ci):
        y, x = _snap_pool(y, ho, pool), _snap_pool(x, wo, pool)
        y = snap_lhs(y, ho, sy, ldy)
        x = snap_lhs(x, wo, sx, ldx)
        yp = (y - 1) * sy + (hk - 1) * dy + 1
        xp = (x - 1) * sx + (wk - 1) * dx + 1
        # largest co_b under the budget: psums 4*b*y*x*co_b plus
        # double-buffered input (b*yp*xp*cib), weight (kk*cib*co_b)
        # and, for a fused join, residual (b*y*x*co_b) panels
        free = vmem_budget - 2 * db * b * yp * xp * cib
        denom = (4 * b * y * x + 2 * db * kk * cib
                 + (2 * db * b * y * x if residual else 0))
        cobs = []
        if free // denom >= 1:
            cobs.append(min(co, int(free // denom)))
        if cib >= ci:
            cobs.append(co)         # weight-pinned: one fetch, 1x buffer
        for cob in cobs:
            cob = balanced_tile(co, cob)
            blk = ConvBlockShape(y=y, x=x, co=cob, ci=cib,
                                 halo_y=yp, halo_x=xp, b=b)
            if blk in seen:
                continue
            seen.add(blk)
            if not fits(blk):
                continue
            cands.append((traffic(blk), blk))
    if not cands:
        raise PlanLegalityError([Diagnostic(
            rule="autotune.vmem", severity="error",
            message=f"no block shape fits the {vmem_budget} B budget "
                    f"for {ci}->{co} k{hk}x{wk} on {ho}x{wo}",
            hint="raise the budget")])
    best = min(cands,
               key=lambda tb: (conv_plan_score(tb[0]),
                               tb[0].reads_w))[1]
    active_tracer().event(
        "plan.autotune", candidates=len(cands),
        enumerated=len(seen), layer=f"{ci}->{co}k{hk}x{wk}",
        best=f"b={best.b},y={best.y},x={best.x},"
             f"ci={best.ci},co={best.co}")
    return best


@lru_cache(maxsize=1024)
def plan_conv(h: int, w: int, ci: int, co: int, hk: int, wk: int, *,
              batch: int = 1, stride=(1, 1), padding=(0, 0),
              dilation=(1, 1), lhs_dilation=(1, 1), pool: int = 1,
              residual: bool = False,
              blocks: ConvBlockShape | None = None,
              dtype_bytes: int = 4,
              vmem_budget: int | None = None,
              autotune: bool = True) -> ConvPlan:
    """Resolve blocks + padding for a (B, H, W, Ci) -> Co conv (one
    group), LRU-cached on the full layer geometry.  Auto-chosen plans
    (``blocks=None``) pass the legality check before they are returned;
    explicit ``blocks`` are the caller's contract.  With
    ``lhs_dilation != (1, 1)``, ``h``/``w`` are the dilated extents."""
    sy, sx = _pair(stride)
    py, px = _pair(padding)
    dy, dx = _pair(dilation)
    ldy, ldx = _pair(lhs_dilation)
    hp, wp = h + 2 * py, w + 2 * px
    ekh, ekw = (hk - 1) * dy + 1, (wk - 1) * dx + 1   # dilated extent
    ho = (hp - ekh) // sy + 1
    wo = (wp - ekw) // sx + 1
    if pool > 1 and (ho % pool or wo % pool):
        raise ValueError(f"fused pool={pool} needs pool-divisible "
                         f"output plane, got {ho}x{wo}")
    if (ldy, ldx) != (1, 1) and (pool > 1 or residual):
        raise ValueError("lhs-dilated plans fuse no pool/residual "
                         "epilogue (dgrad/transposed convs have none)")
    budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
    auto = blocks is None
    if blocks is None:
        with active_tracer().span(
                "plan.search", layer=f"{ci}->{co}k{hk}x{wk}",
                h=h, w=w, batch=batch, autotune=autotune) as _sp:
            blocks = conv_lb_block_shape(ho, wo, ci, co, hk, wk,
                                         batch=batch, stride=(sy, sx),
                                         dilation=(dy, dx),
                                         dtype_bytes=dtype_bytes,
                                         vmem_budget=budget)
            if autotune:
                blocks = autotune_conv_blocks(
                    batch, ho, wo, ci, co, hk, wk, stride=(sy, sx),
                    dilation=(dy, dx), lhs_dilation=(ldy, ldx),
                    pad=(py, px), pool=pool, residual=residual,
                    dtype_bytes=dtype_bytes,
                    vmem_budget=budget, seed=blocks)
            _sp.set(blocks=f"b={blocks.b},y={blocks.y},x={blocks.x},"
                           f"ci={blocks.ci},co={blocks.co}")
    ty = _snap_pool(min(blocks.y, ho), ho, pool)
    tx = _snap_pool(min(blocks.x, wo), wo, pool)
    if ldy > 1 and (ty * sy) % ldy:
        step = ldy // _gcd(ldy, sy)
        ty = min(round_up(ty, step), round_up(ho, step))
    if ldx > 1 and (tx * sx) % ldx:
        step = ldx // _gcd(ldx, sx)
        tx = min(round_up(tx, step), round_up(wo, step))
    cib, cob = min(blocks.ci, ci), min(blocks.co, co)
    tb = max(1, min(blocks.b, batch))
    blocks = ConvBlockShape(y=ty, x=tx, co=cob, ci=cib,
                            halo_y=(ty - 1) * sy + ekh,
                            halo_x=(tx - 1) * sx + ekw, b=tb)
    ho_pad, wo_pad = round_up(ho, ty), round_up(wo, tx)
    plan = ConvPlan(blocks=blocks, ho=ho, wo=wo,
                    ho_pad=ho_pad, wo_pad=wo_pad,
                    hp_pad=max(hp, (ho_pad - 1) * sy + ekh),
                    wp_pad=max(wp, (wo_pad - 1) * sx + ekw),
                    ci_pad=round_up(ci, cib), co_pad=round_up(co, cob),
                    stride=(sy, sx), dilation=(dy, dx),
                    lhs_dilation=(ldy, ldx), pool=pool,
                    hk=hk, wk=wk,
                    h=h, w=w, ci=ci, co=co, py=py, px=px,
                    residual=residual)
    if auto:
        diags = check_conv_plan(plan, batch=batch,
                                dtype_bytes=dtype_bytes,
                                vmem_budget=budget)
        if errors(diags):
            raise PlanLegalityError(diags)
    return plan


def conv_lb_traffic(batch: int, h: int, w: int, ci: int, co: int,
                    hk: int, wk: int, *, stride=1, padding=0,
                    dilation=1, groups: int = 1, pool: int = 1,
                    plan: ConvPlan | None = None,
                    vmem_budget: int | None = None,
                    dtype_bytes: int = 4,
                    autotune: bool = True) -> tuple[Traffic, ConvPlan]:
    """Words moved for this layer (per-group geometry x ``groups``).
    ``autotune=False`` scores the closed-form plan.  With an explicit
    ``plan``, a ``pool`` > 1 overrides the plan's (its blocks must be
    pool-aligned); ``pool=1`` defers to ``plan.pool``."""
    ci_g, co_g = ci // groups, co // groups
    if plan is None:
        plan = plan_conv(h, w, ci_g, co_g, hk, wk, batch=batch,
                         stride=_pair(stride), padding=_pair(padding),
                         dilation=_pair(dilation), pool=pool,
                         dtype_bytes=dtype_bytes,
                         vmem_budget=vmem_budget, autotune=autotune)
    elif pool > 1 and plan.pool != pool:
        if plan.blocks.y % pool or plan.blocks.x % pool:
            raise ValueError(f"plan tiles {plan.blocks.y}x{plan.blocks.x}"
                             f" are not pool={pool} aligned")
        plan = dataclasses.replace(plan, pool=pool)
    t = plan.traffic(batch)
    t = Traffic(reads_in=t.reads_in * groups,
                reads_w=t.reads_w * groups,
                reads_out=0.0,
                writes_out=t.writes_out * groups)
    return t, plan


def conv_lb_traffic_bytes(*args, dtype: torch.dtype | None = None,
                          dtype_bytes: int | None = None,
                          **kw) -> float:
    """Total bytes moved (all tensors at one word size): the word size
    comes from ``dtype`` when given, an explicit ``dtype_bytes``
    overrides it, and with neither the words are f32."""
    if dtype_bytes is None:
        dtype_bytes = dtype.itemsize if dtype is not None else 4
    t, _ = conv_lb_traffic(*args, dtype_bytes=dtype_bytes, **kw)
    return t.total * dtype_bytes


def conv2d_lb(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor | None = None,
              residual: torch.Tensor | None = None, *,
              stride=1, padding=0, dilation=1, lhs_dilation=1,
              groups: int = 1, relu: bool = False,
              pool: int = 1) -> torch.Tensor:
    """NHWC conv with the fused epilogue.

    x: (B, H, W, Ci); w: (Hk, Wk, Ci/groups, Co) -> (B, Ho/pool,
    Wo/pool, Co).  ``stride``/``padding``/``dilation`` take an int or
    an (h, w) pair; ``dilation`` is kernel (rhs) dilation;
    ``lhs_dilation`` inserts ``ld - 1`` zeros between input rows/cols
    logically (x stays the compact plane).  ``bias`` (Co,),
    ``residual`` (a (B, Ho, Wo, Co) pre-pool tensor added after the bias
    and before the ReLU), ``relu`` and an aligned ``pool`` x ``pool``
    max-pool form the epilogue, applied to the f32 sums before the one
    store.  Each group runs
    :func:`~repro_torch.kernels.conv_lb.kernel.conv_lb`: the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    sy, sx = _pair(stride)
    py, px = _pair(padding)
    dy, dx = _pair(dilation)
    ldy, ldx = _pair(lhs_dilation)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Ci) and w (Hk, Wk, Ci/g, "
                         f"Co); got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    ci = x.shape[3]
    ci_g, co = w.shape[2], w.shape[3]
    if ci_g * groups != ci or co % groups:
        raise ValueError(f"groups={groups} incompatible with "
                         f"Ci={ci}, w Ci={ci_g}, Co={co}")
    if (ldy, ldx) != (1, 1) and (pool > 1 or residual is not None):
        raise ValueError("lhs-dilated convs fuse no pool/residual "
                         "epilogue")
    kw = dict(stride=(sy, sx), padding=(py, px), dilation=(dy, dx),
              lhs_dilation=(ldy, ldx), relu=relu, pool=pool)
    if groups == 1:
        return conv_lb(x, w, bias, residual, **kw)
    co_g = co // groups
    outs = []
    for g in range(groups):
        cs = slice(g * co_g, (g + 1) * co_g)
        outs.append(conv_lb(
            x[..., g * ci_g:(g + 1) * ci_g].contiguous(),
            w[..., cs].contiguous(),
            None if bias is None else bias[cs].contiguous(),
            None if residual is None else residual[..., cs].contiguous(),
            **kw))
    return torch.cat(outs, dim=-1)
