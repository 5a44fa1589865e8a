"""Planner, traffic accountant and the differentiable op of the
paper-dataflow conv — the port's copy of
``repro/kernels/conv_lb/ops.py``.

Two halves, kept apart on purpose:

  * **Accounting.**  :func:`plan_conv` (LRU-cached) resolves the
    reference planner's batch-folded ``(b, y, x, ci, co)`` blocks —
    the paper's closed form seeds a traffic-guided autotuner
    (:func:`autotune_conv_blocks`) — and :meth:`ConvPlan.traffic`
    counts the words those blocks move under the reference's refetch
    rule: a block is fetched again only when its index changes between
    consecutive steps of the grid (nb, ny, nx, nco, nci), nci
    innermost.  A training step adds the dgrad conv
    (:func:`plan_conv_dgrad`) and the dW-stationary wgrad schedule
    (:class:`WgradPlan`), combined per layer by
    :func:`plan_conv_training`.  The serve ledger and the training
    report charge these plans, so they equal the reference's word for
    word.
  * **Execution.**  :func:`conv2d_lb` runs the conv, group by group,
    through :func:`repro_torch.kernels.conv_lb.kernel.conv_lb`: the
    hand-written CUDA kernel on a CUDA tensor, its plain PyTorch
    version on a CPU tensor.  Its backward (:class:`ConvLb`) runs on
    the same kernel (the pre-epilogue recompute and dgrad) and on the
    wgrad kernel (:func:`repro_torch.kernels.conv_lb.wgrad.wgrad_lb`),
    except where the reference itself routes to lax: there it routes
    to the library rung (cuDNN on the card), loudly, and counts it
    (:data:`FALLBACK_COUNTS`).
    The kernels tile for the card, not for the accounting plans; what
    they move on the card is a measurement of its own, not a change to
    the ledger.
"""

from __future__ import annotations

import dataclasses
import threading
from functools import lru_cache
from math import gcd as _gcd

import torch
import torch.nn.functional as F

from repro_torch.analysis.plan_check import (TARGET_INTERPRET, TARGET_SM90,
                                             Diagnostic, PlanLegalityError,
                                             check_conv_plan,
                                             check_launch_plan, errors,
                                             format_diagnostics,
                                             launch_facts)
from repro_torch.core.dataflow import Traffic
from repro_torch.core.exec_target import KERNEL
from repro_torch.core.hopper_adapter import (REF_PLAN_BUDGET,
                                             ConvBlockShape, balanced_tile,
                                             conv_block_candidates,
                                             conv_lb_block_shape, round_up)
from repro_torch.core.layer import balanced_candidates, ceil_div
from repro_torch.core.lower_bound import (q_dram_dgrad, q_dram_practical,
                                          q_dram_wgrad)
from repro_torch.kernels.conv_lb.kernel import (conv_lb, conv_lb_dgrad,
                                                dgrad_on_kernel,
                                                launch_plan)
from repro_torch.kernels.conv_lb.ref import (conv2d_ref, epilogue,
                                            lhs_dilate)
from repro_torch.kernels.conv_lb.wgrad import WgradGeometry, wgrad_lb
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


def compact_axis_dims(block: int, halo: int, stride: int, ld: int,
                      pad: int) -> tuple[int, int, int]:
    """Compact-plane walk geometry for one lhs-dilated axis — a copy of
    ``repro/kernels/conv_lb/kernel.py:99-113``.

    Returns ``(chalo, step, off)``: the compact rows fetched per tile,
    the compact-row advance between neighbouring tiles, and the local
    offset of logical dilated row 0 inside the reconstructed tile
    (``ceil(pad/ld)*ld - pad``, the phase shift that aligns the conv
    padding onto the zero-dilation grid).  Requires the dilated-plane
    tile offset ``block*stride`` to divide by ``ld``."""
    if ld == 1:
        return halo, block * stride, 0
    if (block * stride) % ld:
        raise ValueError(f"block {block} * stride {stride} is not a "
                         f"multiple of lhs_dilation {ld}")
    off = ceil_div(pad, ld) * ld - pad      # in [0, ld)
    return compact_halo(halo, ld, pad), (block * stride) // ld, off


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
    def grid(self) -> tuple[int, int, int, int]:
        """(ny, nx, nco, nci) — spatial/channel grid extents (the
        batch extent is ceil(B / blocks.b), B is not plan state)."""
        return (self.ho_pad // self.blocks.y,
                self.wo_pad // self.blocks.x,
                self.co_pad // self.blocks.co,
                self.ci_pad // self.blocks.ci)

    @property
    def lhs_dilated(self) -> bool:
        return self.lhs_dilation != (1, 1)

    def compact_geometry(self) -> tuple[tuple[int, int, int, int],
                                        tuple[int, int, int, int]]:
        """Per-axis ``(chalo, step, pad_lo, total)`` of the compact
        plane the blocks walk when ``lhs_dilated``: rows fetched per
        tile, compact rows advanced between tiles, leading zero-rows of
        conv padding (``ceil(p/ld)``), and the padded compact plane
        extent the last tile's fetch reaches.  For a plain plan this
        degenerates to the dilated-coordinate walk ``(halo,
        block*stride, p, hp_pad)`` (``repro/kernels/conv_lb/ops.py:
        150-176``)."""
        out = []
        for blk, s, halo, ld, p, n, full in (
                (self.blocks.y, self.stride[0], self.blocks.halo_y,
                 self.lhs_dilation[0], self.py,
                 self.ho_pad // self.blocks.y, self.hp_pad),
                (self.blocks.x, self.stride[1], self.blocks.halo_x,
                 self.lhs_dilation[1], self.px,
                 self.wo_pad // self.blocks.x, self.wp_pad)):
            chalo, step, _off = compact_axis_dims(blk, halo, s, ld, p)
            pc = ceil_div(p, ld)
            total = ((n - 1) * step + chalo) if ld > 1 else full
            out.append((chalo, step, pc if ld > 1 else p, total))
        return tuple(out)

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

    def training_traffic(self, batch: int, *, dtype_bytes: int = 4,
                         vmem_budget: int | None = None,
                         autotune: bool = True) -> "TrainingTraffic":
        """Words one *training step* moves through this layer: forward
        + dgrad + wgrad, each accounted off its own planned dataflow
        (the backward plans derived from this forward handle by
        :func:`plan_conv_training`)."""
        return plan_conv_training(
            self, batch=batch, dtype_bytes=dtype_bytes,
            vmem_budget=vmem_budget, autotune=autotune).traffic(batch)

    def launch(self, batch: int, dtype: torch.dtype):
        """``(route, plan, shape)`` of K1's launch of this conv at
        ``batch`` in ``dtype`` (:func:`~repro_torch.kernels.conv_lb.
        kernel.launch_plan`, operands aligned), ``shape`` as
        :func:`~repro_torch.analysis.plan_check.check_launch_plan`
        reads it."""
        conv = ((batch, self.h, self.w, self.ci),
                (self.hk, self.wk, self.ci, self.co), tuple(self.stride),
                (self.py, self.px), tuple(self.dilation),
                tuple(self.lhs_dilation), self.pool)
        return (*launch_plan(dtype, *conv), conv)

    def explain(self, *, batch: int = 1, dtype_bytes: int = 4,
                vmem_budget: int | None = None,
                target: str | None = None,
                dtype: torch.dtype | None = None) -> str:
        """Human-readable account of this plan: block geometry, grid,
        working set against the budget (``REF_PLAN_BUDGET``, the
        reference's ``VMEM_BYTES // 2``), per-operand traffic split, and
        every :class:`~repro_torch.analysis.plan_check.Diagnostic` the
        verifier raises against it (``repro/kernels/conv_lb/ops.py:
        220-258``).  Under ``target="sm90"`` a line more names K1's
        launch at ``batch`` in ``dtype`` (default f32): its route, tile,
        and each launch's shared memory and grid; the verifier line
        then holds the ``sm90`` rules' findings too."""
        target = TARGET_INTERPRET if target is None else target
        budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
        blk = self.blocks
        pinned = blk.ci >= self.ci_pad and blk.co >= self.co_pad
        need = blk.vmem_bytes(self.hk, self.wk, dtype_bytes,
                              w_pinned=pinned, residual=self.residual)
        t = self.traffic(batch)
        ny, nx, nco, nci = self.grid
        diags = check_conv_plan(self, batch=batch, dtype_bytes=dtype_bytes,
                                vmem_budget=vmem_budget)
        lines = [
            f"conv plan {self.ci}->{self.co} k{self.hk}x{self.wk} "
            f"s{self.stride} d{self.dilation} on {self.h}x{self.w} "
            f"(out {self.ho}x{self.wo}, pool {self.pool}"
            f"{', residual join' if self.residual else ''})",
            f"  blocks: b={blk.b} y={blk.y} x={blk.x} ci={blk.ci} "
            f"co={blk.co} halo={blk.halo_y}x{blk.halo_x}"
            f"{' [weights pinned]' if pinned else ''}",
            f"  grid:   ny={ny} nx={nx} nco={nco} nci={nci} "
            f"(x ceil(B/{blk.b}) batch blocks)",
            f"  vmem:   {need} B of {budget} B "
            f"({100.0 * need / max(1, budget):.0f}%)",
            f"  traffic @B={batch}: in={t.reads_in:.4g} "
            f"w={t.reads_w:.4g} out={t.writes_out:.4g} "
            f"(total {t.total:.4g} words)"]
        if target == TARGET_SM90:
            dtype = torch.float32 if dtype is None else dtype
            rt, plan, conv = self.launch(batch, dtype)
            tile = plan if isinstance(plan, tuple) else plan.tile
            facts = launch_facts("conv_lb", rt, plan, conv, dtype)
            lines.append(
                f"  launch @B={batch} {str(dtype).removeprefix('torch.')}: "
                f"{rt} tile {tile}; " + "; ".join(
                    f"{f.source} smem {f.smem_bytes} B grid {f.grid}"
                    for f in facts))
            diags += check_launch_plan("conv_lb", rt, plan, conv, dtype)
        lines.append(f"  verifier [{target}]: {format_diagnostics(diags)}")
        return "\n".join(lines)


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


# --------------------------------------------------------------------------
# backward pass: dgrad / wgrad as planned convs (accounting)
# --------------------------------------------------------------------------

def dgrad_rides_kernel(plan: ConvPlan) -> bool:
    """True when the layer's dgrad can execute through the conv kernel
    itself: a forward padding the full-padding transform can absorb.
    Unit-stride layers run the plain conv over the flipped weights;
    strided layers run the *same* kernel over the compact dy plane
    with ``lhs_dilation = stride``."""
    ekh = (plan.hk - 1) * plan.dilation[0] + 1
    ekw = (plan.wk - 1) * plan.dilation[1] + 1
    return plan.py <= ekh - 1 and plan.px <= ekw - 1


def plan_conv_dgrad(plan: ConvPlan, *, batch: int = 1,
                    dtype_bytes: int = 4,
                    vmem_budget: int | None = None,
                    autotune: bool = True) -> ConvPlan:
    """Plan the layer's *dgrad* conv (dx from dy) off a forward handle.

    dx is the conv of dy with the spatially-flipped ``(Hk, Wk, Co, Ci)``
    weights at unit stride and full padding; a strided forward
    lhs-dilates the dy plane first (``stride-1`` zeros between dy
    rows/cols), which the kernel executes off the *compact* plane
    (``lhs_dilation = stride``): the plan is over the dilated extents
    but its traffic charges dy words only."""
    sy, sx = plan.stride
    hd = plan.ho if sy == 1 else (plan.ho - 1) * sy + 1
    wd = plan.wo if sx == 1 else (plan.wo - 1) * sx + 1
    ekh = (plan.hk - 1) * plan.dilation[0] + 1
    ekw = (plan.wk - 1) * plan.dilation[1] + 1
    return plan_conv(hd, wd, plan.co, plan.ci, plan.hk, plan.wk,
                     batch=batch, stride=(1, 1),
                     padding=(max(0, ekh - 1 - plan.py),
                              max(0, ekw - 1 - plan.px)),
                     dilation=plan.dilation,
                     lhs_dilation=(sy, sx), dtype_bytes=dtype_bytes,
                     vmem_budget=vmem_budget, autotune=autotune)


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """dW-stationary tiled schedule for the layer's *wgrad* conv — the
    reference's accounting of its wgrad kernel.

    dW is the conv of the padded input with the incoming gradient as
    the kernel plane:

      dW[ky, kx, ci, co] = sum_{b, oy, ox}
          x_pad[b, ky*dil + oy*stride, kx*dil + ox*stride, ci]
          * dy[b, oy, ox, co]

    Batch folds into the reduction, so a ``(Hk, Wk, ci_b, co_b)`` block
    of dW stays resident (OutR on the weight gradient, written once)
    while matching spatial strips of x and dy stream through, image
    after image.  Per (ci-block, co-block) sweep each step fetches a
    disjoint ``strip*stride``-row x block while the ``ekh - stride``
    halo rows stay in a carry; the compute lags the fetch by
    ``lag = ceil((ekh - stride)/(strip*stride))`` steps.  x is
    re-fetched once per Co-block sweep, dy once per Ci-block sweep.
    The port's CUDA kernel (:mod:`.wgrad`) tiles for the card; this
    plan is what the ledger charges.
    """

    hk: int            # dW spatial extent (= fwd kernel)
    wk: int
    ci: int
    co: int
    ho: int            # dy plane (the wgrad reduction's spatial extent)
    wo: int
    wp: int            # padded input plane cols
    ekh: int           # dilated kernel extent (x strip halo rows)
    sy: int            # fwd stride (x rows advanced per dy row)
    ci_b: int          # resident dW block channels
    co_b: int
    strip: int         # dy rows streamed per strip
    sx: int = 1        # fwd stride cols
    ekw: int = 1       # dilated kernel extent cols
    dly: int = 1       # rhs (kernel) dilation
    dlx: int = 1
    py: int = 0        # fwd conv padding
    px: int = 0
    h: int = 0         # true input plane rows

    @property
    def n_strips(self) -> int:
        return ceil_div(self.ho, self.strip)

    @property
    def lag(self) -> int:
        """Fetch steps the compute trails behind: the resident carry
        holds ``K = ekh - stride`` halo rows spanning the previous
        ``lag`` disjoint fetches (0 when ``ekh <= stride``)."""
        k = self.ekh - self.sy
        return ceil_div(k, self.strip * self.sy) if k > 0 else 0

    @property
    def ho_pad(self) -> int:
        """dy rows after strip alignment (zero-padded tail)."""
        return self.n_strips * self.strip

    @property
    def grid(self) -> tuple[int, int, int]:
        """(n_ci_blocks, n_co_blocks, n_strips)."""
        return (ceil_div(self.ci, self.ci_b),
                ceil_div(self.co, self.co_b),
                self.n_strips)

    def _x_rows(self) -> int:
        """x rows fetched per image-channel plane pass: ``n_strips +
        lag`` fetches of ``strip*stride`` rows each."""
        return (self.n_strips + self.lag) * self.strip * self.sy

    def traffic(self, batch: int) -> Traffic:
        """HBM words one wgrad pass moves at ``batch`` images: x is
        re-read once per Co-block sweep, dy once per Ci-block sweep,
        the dW block accumulates on chip and is written once."""
        nci, nco, _ = self.grid
        ci_pad = nci * self.ci_b
        co_pad = nco * self.co_b
        reads_x = nco * batch * ci_pad * self._x_rows() * self.wp
        reads_dy = nci * batch * co_pad * self.ho_pad * self.wo
        writes = self.hk * self.wk * ci_pad * co_pad
        return Traffic(reads_in=float(reads_x), reads_w=float(reads_dy),
                       reads_out=0.0, writes_out=float(writes))

    def traffic_bytes(self, batch: int, dtype_bytes: int = 4) -> float:
        return self.traffic(batch).total * dtype_bytes

    def footprint_elems(self) -> int:
        """On-chip words S of the paper's model: resident dW block +
        one x strip + one dy strip (no double buffering)."""
        xrows = (self.strip - 1) * self.sy + self.ekh
        return (self.hk * self.wk * self.ci_b * self.co_b
                + xrows * self.wp * self.ci_b
                + self.strip * self.wo * self.co_b)


def plan_conv_wgrad(plan: ConvPlan, *, dtype_bytes: int = 4,
                    vmem_budget: int | None = None,
                    autotune: bool = True) -> WgradPlan:
    """Choose the dW-stationary blocks for a layer's wgrad conv off a
    forward handle: minimize the re-read volume
    ``n_co_blocks*|x| + n_ci_blocks*|dy|`` under the budget (resident
    f32 dW block + double-buffered x/dy strips).  LRU-cached on the
    forward geometry it reads, which leaves out the forward's blocks: the
    handles of every arrival batch share one search."""
    return _plan_conv_wgrad(plan.hk, plan.wk, plan.ci, plan.co, plan.h,
                            plan.w, plan.ho, plan.wo, plan.py, plan.px,
                            tuple(plan.stride), tuple(plan.dilation),
                            dtype_bytes, vmem_budget, autotune)


@lru_cache(maxsize=1024)
def _plan_conv_wgrad(hk: int, wk: int, ci: int, co: int, h: int, w: int,
                     ho: int, wo: int, py: int, px: int,
                     stride: tuple[int, int], dilation: tuple[int, int],
                     dtype_bytes: int, vmem_budget: int | None,
                     autotune: bool) -> WgradPlan:
    budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
    db = dtype_bytes
    sy, sx = stride
    ekh = (hk - 1) * dilation[0] + 1
    ekw = (wk - 1) * dilation[1] + 1
    wp = w + 2 * px

    def mk(cib, cob, s):
        return WgradPlan(hk=hk, wk=wk, ci=ci, co=co, ho=ho, wo=wo, wp=wp,
                         ekh=ekh, sy=sy, ci_b=cib, co_b=cob, strip=s,
                         sx=sx, ekw=ekw, dly=dilation[0], dlx=dilation[1],
                         py=py, px=px, h=h)

    def vmem_bytes(cib, cob, s):
        xrows = (s - 1) * sy + ekh
        return (4 * hk * wk * cib * cob               # f32 dW psums
                + 2 * db * xrows * wp * cib           # double-buffered
                + 2 * db * s * wo * cob)              # streamed strips

    ci_cands = balanced_candidates(ci)
    co_cands = balanced_candidates(co)
    s_cands = balanced_candidates(ho) if autotune else [1]
    best = mk(1, 1, 1)      # minimal block: always the fallback
    best_cost = None
    for cib in ci_cands:
        for cob in co_cands:
            for s in s_cands:
                if vmem_bytes(cib, cob, s) > budget:
                    continue
                cand = mk(cib, cob, s)
                # reads scale uniformly with batch and writes are
                # batch-free, so ranking at batch=1 is batch-robust
                cost = cand.traffic(1).total
                if best_cost is None or cost < best_cost:
                    best, best_cost = cand, cost
    return best


@dataclasses.dataclass(frozen=True)
class TrainingTraffic:
    """Per-training-step HBM words, split by pass."""

    fwd: Traffic
    dgrad: Traffic
    wgrad: Traffic

    @property
    def total(self) -> float:
        return self.fwd.total + self.dgrad.total + self.wgrad.total

    @property
    def bwd_share(self) -> float:
        """Fraction of the step's words moved by the backward convs."""
        return (self.dgrad.total + self.wgrad.total) / max(self.total,
                                                           1e-30)

    def total_bytes(self, dtype_bytes: int = 4) -> float:
        return self.total * dtype_bytes


@dataclasses.dataclass(frozen=True)
class ConvTrainingPlan:
    """The three planned convs of one layer's training step.

    ``dgrad_kernel`` keeps the reference's flag: whether its dx
    executes through the planned conv kernel (False for grouped
    layers, or a forward padding past the full-padding transform).
    The port runs grouped layers per group through the kernels all the
    same; the flag is accounting."""

    fwd: ConvPlan
    dgrad: ConvPlan
    wgrad: WgradPlan
    dgrad_kernel: bool

    def traffic(self, batch: int) -> TrainingTraffic:
        """Words per training step at ``batch`` images."""
        return TrainingTraffic(fwd=self.fwd.traffic(batch),
                               dgrad=self.dgrad.traffic(batch),
                               wgrad=self.wgrad.traffic(batch))

    def traffic_bytes(self, batch: int, dtype_bytes: int = 4) -> float:
        return self.traffic(batch).total_bytes(dtype_bytes)

    def bound_words(self, layer) -> float:
        """q_dram_training with each pass's Eq. (15) term evaluated at
        that pass's *realized* plan footprint; the forward term rides
        :meth:`ConvPlan.bound_words`, so a fused residual join's
        mandatory read is on the bound side too."""
        return (self.fwd.bound_words(layer)
                + q_dram_dgrad(layer, self.dgrad.footprint_elems())
                + q_dram_wgrad(layer, self.wgrad.footprint_elems()))


def plan_conv_training(fwd: ConvPlan, *, batch: int, groups: int = 1,
                       dtype_bytes: int = 4,
                       vmem_budget: int | None = None,
                       autotune: bool = True) -> ConvTrainingPlan:
    """Derive the full training-step plan triple from a forward handle
    (every constituent ``plan_conv`` call is memoized).  ``groups`` is
    the executed conv's group count; it gates ``dgrad_kernel`` as in
    the reference."""
    if not (fwd.ci and fwd.co):
        raise ValueError("forward plan carries no layer geometry; "
                         "build it via plan_conv")
    kw = dict(dtype_bytes=dtype_bytes, vmem_budget=vmem_budget,
              autotune=autotune)
    return ConvTrainingPlan(
        fwd=fwd,
        dgrad=plan_conv_dgrad(fwd, batch=batch, **kw),
        wgrad=plan_conv_wgrad(fwd, **kw),
        dgrad_kernel=dgrad_rides_kernel(fwd) and groups == 1)


# --------------------------------------------------------------------------
# execution: the forward and its backward through the kernels
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvArgs:
    """The geometry and epilogue of one :func:`conv2d_lb` call."""

    stride: tuple[int, int]
    padding: tuple[int, int]
    dilation: tuple[int, int]
    lhs_dilation: tuple[int, int]
    groups: int
    relu: bool
    pool: int


def _per_group(x, w, bias, residual, a: ConvArgs, *, relu: bool,
               pool: int) -> torch.Tensor:
    """The conv group by group through
    :func:`~repro_torch.kernels.conv_lb.kernel.conv_lb`."""
    kw = dict(stride=a.stride, padding=a.padding, dilation=a.dilation,
              lhs_dilation=a.lhs_dilation, relu=relu, pool=pool)
    if a.groups == 1:
        return conv_lb(x, w, bias, residual, **kw)
    ci_g, co_g = w.shape[2], w.shape[3] // a.groups
    outs = []
    for g in range(a.groups):
        cs = slice(g * co_g, (g + 1) * co_g)
        outs.append(conv_lb(
            x[..., g * ci_g:(g + 1) * ci_g].contiguous(),
            w[..., cs].contiguous(),
            None if bias is None else bias[cs].contiguous(),
            None if residual is None else residual[..., cs].contiguous(),
            **kw))
    return torch.cat(outs, dim=-1)


def max_pool_vjp(a: torch.Tensor, pool: int, g: torch.Tensor
                 ) -> torch.Tensor:
    """Pull ``g`` (B, H/p, W/p, C) back through the aligned ``pool`` x
    ``pool`` max of ``a`` (B, H, W, C): each window's gradient goes to
    one maximum, the first in row-major order, as the reference's
    ``reduce_window`` max does (not spread over ties)."""
    b, h, w, c = a.shape
    hp, wp = h // pool, w // pool
    win = (a.reshape(b, hp, pool, wp, pool, c).permute(0, 1, 3, 5, 2, 4)
           .reshape(b, hp, wp, c, pool * pool))
    idx = win.argmax(dim=-1, keepdim=True)
    gw = torch.zeros_like(win).scatter_(-1, idx, g.unsqueeze(-1))
    return (gw.reshape(b, hp, wp, c, pool, pool).permute(0, 1, 4, 2, 5, 3)
            .reshape(b, h, w, c))


def relu_slope(z: torch.Tensor) -> torch.Tensor:
    """The ReLU's derivative as the reference takes it: 1 above zero,
    0 below, and 1/2 at an exact zero (``jnp.maximum(z, 0)`` splits a
    tie's gradient between its two arguments)."""
    return (z > 0).to(z.dtype) + 0.5 * (z == 0).to(z.dtype)


def epilogue_vjp(y: torch.Tensor, bias, residual, relu: bool, pool: int,
                 g: torch.Tensor):
    """Pull ``g`` back through bias -> residual -> ReLU -> pool applied
    to the pre-epilogue sums ``y``: ``(gy, db, dres)`` (``dres`` is
    ``gy``: the join passes its gradient through)."""
    z = y
    if bias is not None:
        z = z + bias
    if residual is not None:
        z = z + residual
    if pool > 1:
        g = max_pool_vjp(torch.clamp_min(z, 0.0) if relu else z, pool, g)
    if relu:
        g = g * relu_slope(z)
    db = None if bias is None else g.sum(dim=(0, 1, 2))
    return g, db, (None if residual is None else g)


def dgrad_lb(gy: torch.Tensor, w: torch.Tensor, a: ConvArgs, h: int,
             wd: int) -> torch.Tensor:
    """dx through the conv kernel, group by group
    (:func:`~repro_torch.kernels.conv_lb.kernel.conv_lb_dgrad`): a
    strided f32 forward's in one launch by output phases on the compact
    gy, written at (h, wd); otherwise gy against the flipped weights at
    full padding, lhs-dilated by the stride after one appended zero
    row/col (its dilated plane otherwise ends ``(h + 2p - ekh) % s``
    rows short of the last input rows), the surplus cropped."""
    kw = dict(stride=a.stride, padding=a.padding, dilation=a.dilation,
              h=h, wd=wd)
    if a.groups == 1:
        return conv_lb_dgrad(gy, w, **kw)
    co_g = w.shape[3] // a.groups
    return torch.cat([conv_lb_dgrad(
        gy[..., g * co_g:(g + 1) * co_g].contiguous(),
        w[..., g * co_g:(g + 1) * co_g].contiguous(), **kw)
        for g in range(a.groups)], dim=-1)


def _wgrad(x: torch.Tensor, gy: torch.Tensor, hk: int, wk: int,
           a: ConvArgs) -> torch.Tensor:
    """dW through the wgrad kernel, group by group."""
    geom = WgradGeometry(hk=hk, wk=wk, stride=a.stride,
                         padding=a.padding, dilation=a.dilation)
    if a.groups == 1:
        return wgrad_lb(x, gy, geom)
    ci_g = x.shape[3] // a.groups
    co_g = gy.shape[3] // a.groups
    return torch.cat([
        wgrad_lb(x[..., g * ci_g:(g + 1) * ci_g].contiguous(),
                 gy[..., g * co_g:(g + 1) * co_g].contiguous(), geom)
        for g in range(a.groups)], dim=-1)


# process-wide tally of the backward's library-rung routes, keyed by
# pass ("bwd": the whole backward, "dgrad": dx only), as the
# reference's ``FALLBACK_COUNTS`` (``ops.py:1001-1029``); each is also
# a loud ``exec.fallback`` event on the active tracer
FALLBACK_COUNTS: dict[str, int] = {}


def record_fallback(conv_pass: str, reason: str, *, layer: str) -> None:
    """One loud route to the library rung: traced event + tally."""
    FALLBACK_COUNTS[conv_pass] = FALLBACK_COUNTS.get(conv_pass, 0) + 1
    active_tracer().event("exec.fallback", to="library", layer=layer,
                          reason=reason, **{"pass": conv_pass})


def exec_fallback_counts() -> dict[str, int]:
    """Snapshot of the per-pass tally."""
    return dict(FALLBACK_COUNTS)


def reset_fallback_counts() -> None:
    FALLBACK_COUNTS.clear()


def _dgrad_on_kernel(a: ConvArgs, hk: int, wk: int) -> bool:
    """Whether K1 runs this conv's dgrad
    (:func:`~repro_torch.kernels.conv_lb.kernel.dgrad_on_kernel`)."""
    return dgrad_on_kernel(hk, wk, a.padding, a.dilation)


def _no_tf32():
    """cuDNN with TF32 off, as the kernels sum in f32."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _library_conv(x, w, bias, residual, a: ConvArgs) -> torch.Tensor:
    """The conv with its epilogue on the library rung: the plain
    version on a CPU tensor; on a CUDA tensor ``F.conv2d`` (cuDNN, TF32
    off) on the zero-inserted plane, then the plain epilogue."""
    if x.device.type == "cpu":
        return conv2d_ref(x, w, bias, residual, stride=a.stride,
                          padding=a.padding, dilation=a.dilation,
                          lhs_dilation=a.lhs_dilation, groups=a.groups,
                          relu=a.relu, pool=a.pool)
    with _no_tf32():
        y = F.conv2d(lhs_dilate(x, a.lhs_dilation).permute(0, 3, 1, 2),
                     w.permute(3, 2, 0, 1), stride=a.stride,
                     padding=a.padding, dilation=a.dilation,
                     groups=a.groups)
    return epilogue(y.permute(0, 2, 3, 1), bias, a.relu, a.pool, residual)


def _library_vjp(x, w, bias, residual, a: ConvArgs, g, need):
    """The VJP of :func:`_library_conv` (cuDNN's backward on a CUDA
    tensor, the plain version's autograd on a CPU one) for the inputs
    flagged in ``need``; None for the others."""
    leaves = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip((x, w, bias, residual), need)]
    with torch.enable_grad():
        out = _library_conv(*leaves, a)
        live = [t for t, n in zip(leaves, need) if t is not None and n]
        grads = iter(torch.autograd.grad(out, live, g))
    return tuple(next(grads) if t is not None and n else None
                 for t, n in zip(leaves, need))


def _library_dgrad(x, w, gy, a: ConvArgs) -> torch.Tensor:
    """dx of the bare conv (no lhs dilation, no epilogue) on the library
    rung: ``torch.nn.grad.conv2d_input``, cuDNN with TF32 off on a CUDA
    tensor."""
    with _no_tf32():
        gx = torch.nn.grad.conv2d_input(
            x.permute(0, 3, 1, 2).shape, w.to(gy.dtype).permute(3, 2, 0, 1),
            gy.permute(0, 3, 1, 2), stride=a.stride, padding=a.padding,
            dilation=a.dilation, groups=a.groups)
    return gx.permute(0, 2, 3, 1).contiguous()


class ConvLb(torch.autograd.Function):
    """The conv with its backward through the kernels — the
    counterpart of the reference's ``kernel_conv`` custom VJP.

    forward: the conv kernel with the fused epilogue.  backward:
      1. recompute the pre-epilogue sums through the conv kernel with
         no epilogue;
      2. pull ``g`` back through the epilogue in plain torch, which
         gives ``db`` and ``dres = gy``;
      3. dx through the conv kernel in the dgrad geometry, only when x
         needs a gradient;
      4. dW through the wgrad kernel.
    Grouped layers run group by group.  Where the reference itself
    routes to lax, this routes to the library rung,
    loudly (:func:`record_fallback`): an lhs-dilated forward takes the
    library's VJP wholesale (:func:`_library_vjp`), and a padding past
    the full-padding transform takes its dx only
    (:func:`_library_dgrad`; steps 1, 2 and 4 stay on the kernels)."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, a: ConvArgs):
        ctx.args = a
        ctx.save_for_backward(x, w, bias, residual)
        return _per_group(x, w, bias, residual, a, relu=a.relu,
                          pool=a.pool)

    @staticmethod
    def backward(ctx, g):
        x, w, bias, residual = ctx.saved_tensors
        a = ctx.args
        hk, wk = w.shape[0], w.shape[1]
        need = ctx.needs_input_grad
        g = g.contiguous()
        layer = f"{x.shape[3]}->{w.shape[3]}k{hk}x{wk}"
        if a.lhs_dilation != (1, 1):
            record_fallback("bwd", "grouped or lhs-dilated forward",
                            layer=layer)
            return _library_vjp(x, w, bias, residual, a, g,
                                need[:4]) + (None,)
        y = _per_group(x, w, None, None, a, relu=False, pool=1)
        gy, db, dres = epilogue_vjp(y, bias, residual, a.relu, a.pool, g)
        gy = gy.contiguous()
        gx = None
        if need[0] and _dgrad_on_kernel(a, hk, wk):
            gx = dgrad_lb(gy, w, a, x.shape[1], x.shape[2])
        elif need[0]:
            record_fallback("dgrad", "padding past the full-padding "
                            "transform", layer=layer)
            gx = _library_dgrad(x, w, gy, a)
        gw = _wgrad(x, gy, hk, wk, a).to(w.dtype) if need[1] else None
        return (gx, gw, db if need[2] else None,
                dres if need[3] else None, None)


def conv2d_lb(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor | None = None,
              residual: torch.Tensor | None = None, *,
              stride=1, padding=0, dilation=1, lhs_dilation=1,
              groups: int = 1, relu: bool = False,
              pool: int = 1) -> torch.Tensor:
    """NHWC conv with the fused epilogue, differentiable through the
    kernels (:class:`ConvLb`).

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
    kernel on a CUDA tensor, the plain version on a CPU tensor.  When
    no input requires a gradient nothing is recorded for a backward."""
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
    if pool > 1:
        # as plan_conv, and the reference's kernel target, refuse: the
        # card's kernel cannot take it, and the plain version's backward
        # would not either
        ho = (x.shape[1] + 2 * py - (w.shape[0] - 1) * dy - 1) // sy + 1
        wo = (x.shape[2] + 2 * px - (w.shape[1] - 1) * dx - 1) // sx + 1
        if ho % pool or wo % pool:
            raise ValueError(f"fused pool={pool} needs pool-divisible "
                             f"output plane, got {ho}x{wo}")
    a = ConvArgs(stride=(sy, sx), padding=(py, px), dilation=(dy, dx),
                 lhs_dilation=(ldy, ldx), groups=groups, relu=relu,
                 pool=pool)
    return ConvLb.apply(x, w, bias, residual, a)


#: per thread: device -> the (start, end) CUDA events
#: :func:`conv2d_lb_timed` records around one call, made once
_TIMING_EVENTS = threading.local()


def _timing_events(device: torch.device):
    pairs = getattr(_TIMING_EVENTS, "pairs", None)
    if pairs is None:
        pairs = _TIMING_EVENTS.pairs = {}
    if device not in pairs:
        pairs[device] = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
    return pairs[device]


def conv2d_lb_timed(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    residual: torch.Tensor | None = None, *,
                    stride=1, padding=0, dilation=1, groups: int = 1,
                    relu: bool = False, pool: int = 1,
                    tracer=None, clock=None,
                    name: str = "kernel.conv2d_lb") -> torch.Tensor:
    """:func:`conv2d_lb` with a synced, *accounted* span around the
    call — the port's counterpart of the reference's
    ``conv2d_lb_timed``: one span carrying both the measured seconds and
    the plan's analytic ``traffic_bytes``, i.e. the achieved-GB/s sample
    the roofline needs, per layer.

    ``tracer`` defaults to the ambient tracer; ``clock`` defaults to the
    tracer's own clock, so under a virtual clock the span's ``us`` and
    ``achieved_gbps`` stay deterministic.  The bytes are
    :func:`plan_conv`'s for this geometry and word size, times
    ``groups``.  On a CUDA tensor the call runs between a pair of CUDA
    events on the current stream and then waits for the device
    (``torch.cuda.synchronize``), so ``us`` holds the host's enqueue and
    the card's work; the span also carries the time between the events
    on the card, ``device_us``, and ``device_gbps``.  Where the stream
    is idle when the call starts (the previous timed layer waited for
    it), ``device_us`` also holds the call's host work before its first
    launch.  It launches the kernel through :func:`conv2d_lb` or raises,
    like it, and returns its output, autograd graph and all."""
    tr = active_tracer() if tracer is None else tracer
    clk = tr.now if clock is None else clock
    sy, sx = _pair(stride)
    py, px = _pair(padding)
    dy, dx = _pair(dilation)
    b, h, wd, ci = x.shape
    hk, wk, ci_g, co = w.shape
    word = x.element_size()
    plan = plan_conv(h, wd, ci_g, co // groups, hk, wk, batch=b,
                     stride=(sy, sx), padding=(py, px), dilation=(dy, dx),
                     pool=pool, residual=residual is not None,
                     dtype_bytes=word)
    n_bytes = groups * plan.traffic_bytes(b, dtype_bytes=word)
    events = _timing_events(x.device) if x.is_cuda else None
    with tr.span(name, layer=f"{ci}->{co}k{hk}x{wk}", mode=KERNEL.name,
                 batch=b, traffic_bytes=n_bytes) as sp:
        t0 = clk()
        if events is not None:
            events[0].record()
        out = conv2d_lb(x, w, bias, residual, stride=stride,
                        padding=padding, dilation=dilation, groups=groups,
                        relu=relu, pool=pool)
        if events is not None:
            events[1].record()
            torch.cuda.synchronize(x.device)
        dt = clk() - t0
        sp.set(us=dt * 1e6,
               achieved_gbps=(n_bytes / dt / 1e9) if dt > 0 else None)
        if events is not None:
            dev_us = events[0].elapsed_time(events[1]) * 1e3
            sp.set(device_us=dev_us,
                   device_gbps=(n_bytes / dev_us / 1e3) if dev_us > 0
                   else None)
    return out
