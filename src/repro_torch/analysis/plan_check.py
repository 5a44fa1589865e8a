"""Static conv plan verifier and traffic cross-audit — the port's copy
of ``repro/analysis/plan_check.py``, with a Hopper legality profile in
place of the reference's TPU one.

  * **Legality pass** — :func:`check_conv_plan` verifies a
    :class:`~repro_torch.kernels.conv_lb.ops.ConvPlan` against the
    structural contract of the reference planner: grid divisibility,
    halo windows in bounds, the lhs-dilated compact walk, fused pool
    alignment, and the working set against the budget;
    :func:`check_wgrad_plan` does the same for a
    :class:`~repro_torch.kernels.conv_lb.ops.WgradPlan`.
    :func:`check_matmul_block` checks the matmul's accounted block
    (``repro/analysis/plan_check.py:412-457``) with the reference's
    rules, severities and messages, its alignment rules included
    (:func:`_lane_rule` / :func:`_sublane_rule`): warnings under the
    ``interpret`` profile the port plans at, errors under ``mosaic``.
  * **Traffic cross-audit** — :func:`symbolic_conv_traffic` /
    :func:`symbolic_wgrad_traffic` / :func:`symbolic_bound_words`
    re-derive each plan's words and its Eq. (15) bound by a second,
    simpler route, and :func:`audit_handles` asserts exact agreement
    with the accountant for every handle the serve ledger and the
    training report charge (forward, dgrad and wgrad plans).
  * **Graph audit** — :func:`audit_graph` runs both passes over every
    node of a :class:`~repro_torch.models.graph.ConvGraph`, giving the
    ``plans checked / plans legal`` counts (``repro/analysis/
    plan_check.py:581-709``).

Targets: ``TARGET_INTERPRET`` is the reference's accounting profile,
and audits the same plans to the same counts.  The reference's
``TARGET_MOSAIC`` gates a compiled TPU kernel's blocks by TPU
alignment, which has no counterpart on the card: a conv audit at it
raises.  In its place ``TARGET_SM90`` gates what the Hopper kernels
launch.  At it every fwd, dgrad and wgrad entry also carries the route
and the launch plan its kernel takes at the audit's batch (from the
kernels' shape-only cores, so the audit picks exactly what the launcher
picks), and :func:`check_launch_plan` holds that plan to the card's
limits (the ``sm90.*`` rules of :data:`RULES`): dynamic shared memory,
grid extents, TMA boxes, traversal strides and 16-byte alignment,
registers, the kernels' argument arrays and the im2col staging plane.
The launchers' own fit predicates (``_sm90_fits``, ``_tf32_fits``,
``stage_fits``, the split's grid limit) are :func:`tile_fits` and
:func:`grid_rule`, so the launcher and the checker cannot disagree.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

from repro_torch.core.dataflow import Traffic
from repro_torch.core.hopper_adapter import (GRID_X_MAX, GRID_YZ_MAX,
                                             REF_ALIGN, REF_PLAN_BUDGET,
                                             REG_ALLOC_UNIT, REGS_PER_SM,
                                             SMEM_PER_BLOCK, TMA_ALIGN,
                                             TMA_BOX_MAX,
                                             TMA_ELEM_STRIDE_MAX,
                                             launch_bounds_regs,
                                             row_align_for)
from repro_torch.core.layer import ceil_div

ERROR = "error"
WARN = "warn"

#: the reference's plan profiles: ``interpret`` (accounting; alignment
#: findings are warnings) and ``mosaic`` (alignment findings are errors;
#: the matmul's accounted block only)
TARGET_INTERPRET = "interpret"
TARGET_MOSAIC = "mosaic"
#: the Hopper profile: the launch plans of the card's kernels
TARGET_SM90 = "sm90"
#: the reference's last-dim tile and systolic-array edge
LANE = MXU_DIM = REF_ALIGN

#: rule id -> one-line meaning: the reference's texts
#: (``repro/analysis/plan_check.py:72-116``) for the rules the port
#: checks, and the Hopper profile's
RULES = {
    "conv.grid": "padded output/channel dims must divide the blocks "
                 "(Pallas grid = padded // block exactly)",
    "conv.halo": "the halo-extended input window of every tile must "
                 "stay inside the padded input plane",
    "conv.pool": "a fused pool must divide the spatial blocks and the "
                 "true output plane (windows never straddle tiles)",
    "conv.vmem": "psums + double-buffered operand panels (+ residual "
                 "join panel, + pinned-weight single buffer) must fit "
                 "the VMEM budget",
    "conv.lhsdil": "an lhs-dilated plan's compact fetches must start "
                   "on the dilation phase (block*stride divisible by "
                   "lhs_dilation) and fuse no pool/residual epilogue",
    "wgrad.vmem": "resident f32 dW block + double-buffered x/dy "
                  "strips must fit the VMEM budget",
    "wgrad.grid": "dW channel blocks must not exceed the layer's "
                  "channel counts",
    "wgrad.strip": "the lagged carry must cover the strip halo "
                   "(lag * strip*stride >= ekh - stride) so the "
                   "rolling disjoint fetches stay exact",
    "matmul.shape": "block dims must be positive and not exceed the "
                    "padded operand dims",
    "matmul.vmem": "psum block + double-buffered A/B panels must fit "
                   "the VMEM budget",
    "mosaic.lane": "a block's last dim must be a LANE (128) multiple "
                   "or cover the full (padded) array dim",
    "mosaic.sublane": "a block's second-minor dim must be a sublane "
                      "multiple for the dtype (f32 8 / bf16 16 / "
                      "int8 32) or cover the full dim",
    "mosaic.mxu": "a reduction slice far below the 128-wide MXU "
                  "leaves the systolic array underfilled (perf, not "
                  "legality)",
    "autotune.vmem": "a search candidate was rejected because its "
                     "working set exceeds the VMEM budget",
    "audit.traffic": "the symbolic traffic/bound re-derivation "
                     "disagrees with the accountant (planner or "
                     "accountant drift)",
    "sm90.smem": "a tile's dynamic shared memory must fit the card's "
                 "opt-in limit per block (and a ring sized to it hold "
                 "two stages)",
    "sm90.grid": "a launch's grid must have 1 to 2^31-1 blocks along x "
                 "and 1 to 65535 along y and z",
    "sm90.tma": "every TMA box extent must be at most 256, every "
                "traversal stride at most 8, and every global stride "
                "and base 16-byte aligned",
    "sm90.regs": "threads x the registers a thread holds (at most what "
                 "__launch_bounds__ allows) x the CTAs per SM a plan's "
                 "wave count assumes must fit an SM's registers",
    "sm90.args": "a launch's windows, halo boxes and output phases must "
                 "fit the kernel's argument arrays",
    "sm90.stage": "the im2col plane must fit the staging kernel "
                  "(stage_fits)",
    "sm90.fma": "a main-path geometry that falls to an FMA route leaves "
                "the tensor cores idle (perf, not legality)",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of the static verifier: ``rule`` indexes
    :data:`RULES`; ``severity`` is ``error`` (the plan must not be
    served) or ``warn``; ``hint`` says how to repair the shape."""

    rule: str
    severity: str
    message: str
    hint: str = ""
    where: str = ""

    def __str__(self) -> str:
        tail = f"  [{self.hint}]" if self.hint else ""
        head = f"{self.where}: " if self.where else ""
        return f"{self.severity}:{self.rule}: {head}{self.message}{tail}"


def errors(diags) -> list[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def format_diagnostics(diags) -> str:
    return "\n".join(str(d) for d in diags) or "clean"


class PlanLegalityError(ValueError):
    """An auto-chosen plan failed the legality pass (a planner bug:
    the search must never emit a structurally illegal plan)."""

    def __init__(self, diags):
        self.diagnostics = list(diags)
        super().__init__("illegal plan:\n" + format_diagnostics(
            errors(self.diagnostics)))


def _err(rule: str, message: str, hint: str = "",
         where: str = "") -> Diagnostic:
    return Diagnostic(rule=rule, severity=ERROR, message=message,
                      hint=hint, where=where)


def _mosaic_sev(target: str) -> str:
    return ERROR if target == TARGET_MOSAIC else WARN


def _lane_rule(block: int, full: int, operand: str, target: str,
               where: str = "") -> Diagnostic | None:
    """Last-dim tile rule: a LANE multiple, or the block covers the
    whole (padded) dim."""
    if block % LANE == 0 or block >= full:
        return None
    legal = min(full, -(-block // LANE) * LANE)
    return Diagnostic(
        rule="mosaic.lane", severity=_mosaic_sev(target), where=where,
        message=f"{operand} last dim {block} is neither a multiple of "
                f"{LANE} nor the full dim {full}",
        hint=f"grow to {legal} (or the full {full})")


def _sublane_rule(block: int, full: int, dtype_bytes: int,
                  operand: str, target: str,
                  where: str = "") -> Diagnostic | None:
    """Second-minor tile rule, keyed by the word size."""
    sub = row_align_for(dtype_bytes)
    if block % sub == 0 or block >= full:
        return None
    legal = min(full, -(-block // sub) * sub)
    return Diagnostic(
        rule="mosaic.sublane", severity=_mosaic_sev(target), where=where,
        message=f"{operand} second-minor dim {block} is not a "
                f"{sub}-row tile ({dtype_bytes}-byte words) nor the "
                f"full dim {full}",
        hint=f"grow to {legal} (or the full {full})")


def check_matmul_block(blk, m: int, n: int, k: int, *,
                       dtype_bytes: int = 2,
                       vmem_budget: int | None = None,
                       target: str = TARGET_INTERPRET,
                       where: str = "") -> list[Diagnostic]:
    """Verify the matmul's accounted
    :class:`~repro_torch.core.hopper_adapter.BlockShape`: a degenerate
    block and a working set over the budget are errors; the alignment
    rules follow ``target``; a reduction slice under the 128-wide
    array is a warning.  The CUDA kernels' own tiles are held to the
    card by :func:`check_launch_plan`."""
    budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
    diags: list[Diagnostic] = []
    for name, b in (("bm", blk.bm), ("bn", blk.bn), ("bk", blk.bk)):
        if b < 1:
            diags.append(_err("matmul.shape", f"{name}={b} < 1",
                              where=where))
    if diags:
        return diags
    need = blk.vmem_bytes(dtype_bytes)
    if need > budget:
        diags.append(_err(
            "matmul.vmem", f"psum + double-buffered panels need "
            f"{need} B > {budget} B budget",
            hint="shrink bm/bn toward the paper's u ~= R*z balance",
            where=where))
    mp, np_, kp = (ceil_div(m, blk.bm) * blk.bm,
                   ceil_div(n, blk.bn) * blk.bn,
                   ceil_div(k, blk.bk) * blk.bk)
    for d in (_lane_rule(blk.bn, np_, "B-panel/psum block", target,
                         where),
              _lane_rule(blk.bk, kp, "A-panel block", target, where),
              _sublane_rule(blk.bm, mp, dtype_bytes, "A-panel/psum "
                            "block", target, where),
              _sublane_rule(blk.bk, kp, dtype_bytes, "B-panel block",
                            target, where)):
        if d:
            diags.append(d)
    if blk.bk < min(MXU_DIM, kp):
        diags.append(Diagnostic(
            rule="mosaic.mxu", severity=WARN, where=where,
            message=f"reduction slice bk={blk.bk} underfills the "
                    f"{MXU_DIM}-wide MXU"))
    return diags


def check_conv_plan(plan, *, batch: int = 1, dtype_bytes: int = 4,
                    vmem_budget: int | None = None,
                    where: str = "") -> list[Diagnostic]:
    """Verify one plan against the structural contract of the
    reference planner, re-derived independently of it."""
    del batch          # plans carry no batch extent
    budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
    blk = plan.blocks
    sy, sx = plan.stride
    ekh = (plan.hk - 1) * plan.dilation[0] + 1
    ekw = (plan.wk - 1) * plan.dilation[1] + 1
    diags: list[Diagnostic] = []

    # -- grid divisibility ---------------------------------------------------
    for name, dim, b in (("ho_pad", plan.ho_pad, blk.y),
                         ("wo_pad", plan.wo_pad, blk.x),
                         ("ci_pad", plan.ci_pad, blk.ci),
                         ("co_pad", plan.co_pad, blk.co)):
        if b < 1 or dim % b:
            diags.append(_err(
                "conv.grid", f"{name}={dim} does not divide its block "
                f"{b}", hint=f"pad {name} to a multiple of {b}",
                where=where))
    for name, dim, true in (("ho", plan.ho_pad, plan.ho),
                            ("wo", plan.wo_pad, plan.wo),
                            ("ci", plan.ci_pad, plan.ci),
                            ("co", plan.co_pad, plan.co)):
        if true and dim < true:
            diags.append(_err(
                "conv.grid", f"padded {name} {dim} is smaller than "
                f"the true dim {true}", where=where))

    # -- halo windows in bounds ----------------------------------------------
    want_hy = (blk.y - 1) * sy + ekh
    want_hx = (blk.x - 1) * sx + ekw
    if (blk.halo_y, blk.halo_x) != (want_hy, want_hx):
        diags.append(_err(
            "conv.halo", f"halo ({blk.halo_y}, {blk.halo_x}) does not "
            f"match the tile's input footprint ({want_hy}, {want_hx})",
            hint="halos belong to the tile: (t-1)*stride + dilated "
                 "kernel extent", where=where))
    if plan.ho_pad // max(1, blk.y):
        last_y = (plan.ho_pad // blk.y - 1) * blk.y * sy + blk.halo_y
        last_x = (plan.wo_pad // blk.x - 1) * blk.x * sx + blk.halo_x
        if last_y > plan.hp_pad or last_x > plan.wp_pad:
            diags.append(_err(
                "conv.halo", f"last tile's halo reads "
                f"({last_y}, {last_x}) past the padded input plane "
                f"({plan.hp_pad}, {plan.wp_pad})",
                hint="pad the input to the last tile's halo end",
                where=where))

    # -- lhs-dilated compact-plane walk --------------------------------------
    if plan.lhs_dilated:
        ldy, ldx = plan.lhs_dilation
        for name, bv, s, ld in (("y", blk.y, sy, ldy),
                                ("x", blk.x, sx, ldx)):
            if ld > 1 and (bv * s) % ld:
                diags.append(_err(
                    "conv.lhsdil",
                    f"{name}-block {bv} * stride {s} is not a multiple "
                    f"of lhs_dilation {ld} — compact fetches would "
                    f"start mid-phase",
                    hint="snap the block so block*stride % lhs_dilation"
                         " == 0", where=where))
        if plan.pool > 1 or plan.residual:
            diags.append(_err(
                "conv.lhsdil", "lhs-dilated plans fuse no "
                "pool/residual epilogue", where=where))

    # -- fused pool alignment ------------------------------------------------
    if plan.pool > 1:
        if blk.y % plan.pool or blk.x % plan.pool:
            diags.append(_err(
                "conv.pool", f"tile {blk.y}x{blk.x} is not divisible "
                f"by the fused pool {plan.pool}",
                hint="snap spatial blocks to pool multiples",
                where=where))
        if plan.ho % plan.pool or plan.wo % plan.pool:
            diags.append(_err(
                "conv.pool", f"output plane {plan.ho}x{plan.wo} is "
                f"not divisible by the fused pool {plan.pool}",
                where=where))

    # -- working set against the budget --------------------------------------
    pinned = blk.ci >= plan.ci_pad and blk.co >= plan.co_pad
    need = blk.vmem_bytes(plan.hk, plan.wk, dtype_bytes,
                          w_pinned=pinned, residual=plan.residual)
    if need > budget:
        diags.append(_err(
            "conv.vmem", f"working set {need} B exceeds the "
            f"{budget} B budget (psum {blk.psum_bytes} B + "
            f"double-buffered panels"
            f"{' + residual join panel' if plan.residual else ''})",
            hint="shrink ci/batch blocks first (they only cost "
                 "memory), then the spatial tile", where=where))
    return diags


def check_wgrad_plan(wplan, *, batch: int = 1, dtype_bytes: int = 4,
                     vmem_budget: int | None = None,
                     where: str = "") -> list[Diagnostic]:
    """Verify a dW-stationary plan: the resident dW block plus
    double-buffered x/dy strips must fit the budget, the channel
    blocks must describe a real partition of the layer, and the lagged
    carry must cover the strip halo."""
    del batch          # plans carry no batch extent
    budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
    diags: list[Diagnostic] = []
    for name, b, dim in (("ci_b", wplan.ci_b, wplan.ci),
                         ("co_b", wplan.co_b, wplan.co),
                         ("strip", wplan.strip, wplan.ho)):
        if b < 1 or b > dim:
            diags.append(_err(
                "wgrad.grid", f"{name}={b} outside [1, {dim}]",
                where=where))
    if diags:
        return diags
    # the lagged rolling fetch: carry rows must cover the halo strips
    # share (re-derived from the raw geometry, not through
    # WgradPlan.lag)
    r_rows = wplan.strip * wplan.sy
    k_rows = max(0, wplan.ekh - wplan.sy)
    lag = -(-k_rows // r_rows) if k_rows > 0 else 0
    if wplan.lag != lag or lag * r_rows < k_rows:
        diags.append(_err(
            "wgrad.strip",
            f"lag {wplan.lag} x {r_rows}-row fetches cannot carry the "
            f"{k_rows}-row strip halo",
            hint="lag must be ceil((ekh - stride) / (strip*stride))",
            where=where))
    xrows = (wplan.strip - 1) * wplan.sy + wplan.ekh
    need = (4 * wplan.hk * wplan.wk * wplan.ci_b * wplan.co_b
            + 2 * dtype_bytes * xrows * wplan.wp * wplan.ci_b
            + 2 * dtype_bytes * wplan.strip * wplan.wo * wplan.co_b)
    if need > budget:
        diags.append(_err(
            "wgrad.vmem", f"resident dW block + strips need {need} B "
            f"> {budget} B budget",
            hint="shrink the strip first, then the channel blocks",
            where=where))
    return diags


def symbolic_conv_traffic(plan, batch: int) -> Traffic:
    """Independent re-derivation of :meth:`ConvPlan.traffic`: fetches
    per operand counted straight from the block walk (an operand is
    re-fetched when its block index changes between consecutive grid
    steps, nci innermost) times the block volume, with ceil divisions
    of the *true* dims."""
    blk = plan.blocks
    tb = max(1, min(blk.b, batch))
    nb = ceil_div(batch, tb)
    ny, nx = ceil_div(plan.ho, blk.y), ceil_div(plan.wo, blk.x)
    nci = ceil_div(plan.ci_pad, blk.ci)
    nco = ceil_div(plan.co_pad, blk.co)
    spatial_blocks = nb * ny * nx
    # the input halo tile is constant across the Co sweep only when
    # there is a sole Ci block
    in_fetches = (spatial_blocks if nci == 1
                  else spatial_blocks * nco * nci)
    fetch_y, fetch_x = blk.halo_y, blk.halo_x
    if plan.lhs_dilated:
        def compact(halo, ld, p):
            if ld == 1:
                return halo
            return ceil_div(p, ld) + max(1, ceil_div(halo - p, ld))
        fetch_y = compact(blk.halo_y, plan.lhs_dilation[0], plan.py)
        fetch_x = compact(blk.halo_x, plan.lhs_dilation[1], plan.px)
    in_words = in_fetches * (tb * fetch_y * fetch_x * blk.ci)
    # the weight slice is constant over the whole grid iff both channel
    # dims have a single block
    w_fetches = 1 if nci * nco == 1 else spatial_blocks * nco * nci
    w_words = w_fetches * (plan.hk * plan.wk * blk.ci * blk.co)
    if plan.residual:
        in_words += spatial_blocks * nco * (tb * blk.y * blk.x * blk.co)
    out_words = (spatial_blocks * nco
                 * (tb * (blk.y // plan.pool) * (blk.x // plan.pool)
                    * blk.co))
    return Traffic(reads_in=float(in_words), reads_w=float(w_words),
                   reads_out=0.0, writes_out=float(out_words))


def symbolic_wgrad_traffic(wplan, batch: int) -> Traffic:
    """Independent re-derivation of :meth:`WgradPlan.traffic`, walked
    off the reference kernel's grid ``(nci, nco, batch, strips +
    lag)``: the disjoint x fetch changes every step (warm-up fetches
    included), the dy strip takes exactly ``strips`` distinct values
    per (ci-block, co-block, image), and the resident dW block flushes
    exactly once."""
    nci = ceil_div(wplan.ci, wplan.ci_b)
    nco = ceil_div(wplan.co, wplan.co_b)
    ns = ceil_div(wplan.ho, wplan.strip)
    r_rows = wplan.strip * wplan.sy
    k_rows = max(0, wplan.ekh - wplan.sy)
    lag = -(-k_rows // r_rows) if k_rows > 0 else 0
    reads_x = (nci * nco * batch * (ns + lag)
               * r_rows * wplan.wp * wplan.ci_b)
    reads_dy = (nci * nco * batch * ns
                * wplan.strip * wplan.wo * wplan.co_b)
    writes = (wplan.hk * wplan.wk) * (nci * wplan.ci_b) * (nco
                                                           * wplan.co_b)
    return Traffic(reads_in=float(reads_x), reads_w=float(reads_dy),
                   reads_out=0.0, writes_out=float(writes))


def symbolic_bound_words(plan, layer) -> float:
    """Independent re-derivation of :meth:`ConvPlan.bound_words`:
    Eq. (15) at the plan's realized footprint, floored at the
    once-per-word ideal, plus the residual join's mandatory read."""
    s = plan.footprint_elems()
    macs = (layer.batch * layer.ho * layer.wo * layer.co
            * layer.hk * layer.wk * layer.ci)
    r = max(1.0, (layer.hk * layer.wk) / float(layer.stride ** 2))
    outputs = layer.batch * layer.co * layer.ho * layer.wo
    touched = (layer.batch * layer.ci
               * layer.fetched_area(layer.wo, layer.ho))
    ideal = float(touched + layer.hk * layer.wk * layer.ci * layer.co
                  + outputs)
    q = max(2.0 * macs / math.sqrt(r * s) + outputs, ideal)
    if plan.residual:
        q += float(outputs)
    return q


# --------------------------------------------------------------------------
# the Hopper profile: what a launch asks of the card
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TmaMap:
    """One TMA tensor map of a launch: its box extents and traversal
    strides (innermost dimension first; ``elem`` empty for unit
    strides), its global strides in bytes (dimensions 1..) and whether
    its base address is 16-byte aligned."""

    operand: str
    box: tuple[int, ...]
    strides: tuple[int, ...]
    elem: tuple[int, ...] = ()
    aligned: bool = True


@dataclasses.dataclass(frozen=True)
class LaunchFacts:
    """What one kernel launch asks of the card, from its plan and
    shapes alone.  ``source`` is the stem of the kernel's source (and
    library); ``min_blocks`` the second argument of its
    ``__launch_bounds__``; ``ctas_per_sm`` the CTAs per SM its plan's
    wave count assumes; ``args`` each argument array's ``(what, count,
    capacity)``; ``stages`` the ring depth where a plan sizes its ring
    to the shared memory; ``stage`` the staging plane ``(b, h, w, ci,
    ho, wo, cp, elt)`` of an im2col launch; ``function`` the part of the
    kernel's (mangled) name that picks the instantiations the launch
    may run; ``regs`` a thread's registers where they are known (the
    card's ``cuobjdump``), else the launch bound's cap is assumed."""

    source: str
    function: str
    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int
    min_blocks: int = 1
    ctas_per_sm: int = 1
    maps: tuple[TmaMap, ...] = ()
    args: tuple[tuple[str, int, int], ...] = ()
    stages: int | None = None
    stage: tuple[int, ...] | None = None
    regs: int | None = None


def smem_rule(smem_bytes: int, stages: int | None = None, *,
              where: str = "") -> Diagnostic | None:
    """``sm90.smem``: at most ``SMEM_PER_BLOCK`` bytes, and a ring sized
    to the shared memory holds at least two stages."""
    if smem_bytes > SMEM_PER_BLOCK:
        return _err("sm90.smem", f"{smem_bytes} B of dynamic shared "
                    f"memory exceeds the card's {SMEM_PER_BLOCK} B a block",
                    hint="a narrower tile or fewer ring stages",
                    where=where)
    if stages is not None and stages < 2:
        return _err("sm90.smem", f"a ring of {stages} stage(s) fits; the "
                    f"kernel needs two", hint="a narrower tile",
                    where=where)
    return None


def grid_rule(grid, *, where: str = "") -> Diagnostic | None:
    """``sm90.grid``: 1 to ``GRID_X_MAX`` blocks along x, 1 to
    ``GRID_YZ_MAX`` along y and z."""
    gx, gy, gz = grid
    if 1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX \
            and 1 <= gz <= GRID_YZ_MAX:
        return None
    return _err("sm90.grid", f"grid {tuple(grid)} is outside (1..{GRID_X_MAX},"
                f" 1..{GRID_YZ_MAX}, 1..{GRID_YZ_MAX})",
                hint="fold the excess into x, or split the launch",
                where=where)


def _box_rules(boxes, elems=(), *, where: str = "") -> list[Diagnostic]:
    """``sm90.tma`` on boxes alone: every extent 1 to ``TMA_BOX_MAX``,
    every traversal stride 1 to ``TMA_ELEM_STRIDE_MAX``."""
    diags = []
    for i, box in enumerate(boxes):
        elem = elems[i] if i < len(elems) and elems[i] else (1,) * len(box)
        if not all(1 <= b <= TMA_BOX_MAX for b in box):
            diags.append(_err("sm90.tma", f"TMA box {tuple(box)} has an "
                              f"extent outside 1..{TMA_BOX_MAX}",
                              hint="a smaller tile or halo", where=where))
        if not all(1 <= e <= TMA_ELEM_STRIDE_MAX for e in elem):
            diags.append(_err("sm90.tma", f"TMA traversal strides "
                              f"{tuple(elem)} exceed {TMA_ELEM_STRIDE_MAX}",
                              where=where))
    return diags


def _args_rules(args, *, where: str = "") -> list[Diagnostic]:
    """``sm90.args``: each of a launch's argument arrays holds its
    entries."""
    return [_err("sm90.args", f"{n} {what} exceed the kernel's {cap}",
                 where=where)
            for what, n, cap in args if n > cap]


def tile_fits(smem_bytes: int, *, boxes=(), elems=(), args=(),
              stages: int | None = None) -> bool:
    """The part of the ``sm90`` rules a tile must pass wherever it
    launches (shared memory, TMA boxes, argument arrays): the fit
    predicate every tensor-core launcher ranks its tiles by."""
    return (smem_rule(smem_bytes, stages) is None
            and not _box_rules(boxes, elems) and not _args_rules(args))


def regs_rule(threads: int, min_blocks: int = 1, ctas_per_sm: int = 1,
              regs: int | None = None, *,
              where: str = "") -> Diagnostic | None:
    """``sm90.regs``: a thread holds at most what ``__launch_bounds__
    (threads, min_blocks)`` allows (``regs``, where known, else that
    cap), and ``ctas_per_sm`` CTAs of ``threads`` at that count, each
    thread's registers allocated in units of ``REG_ALLOC_UNIT``, fit
    ``REGS_PER_SM``."""
    cap = launch_bounds_regs(threads, min_blocks)
    r = cap if regs is None else regs
    if r > cap:
        return _err("sm90.regs", f"{r} registers a thread exceed the "
                    f"{cap} __launch_bounds__({threads}, {min_blocks}) "
                    f"allows", where=where)
    need = (ceil_div(r, REG_ALLOC_UNIT) * REG_ALLOC_UNIT
            * ceil_div(threads, 32) * 32 * ctas_per_sm)
    if need > REGS_PER_SM:
        return _err("sm90.regs", f"{ctas_per_sm} CTA(s) of {threads} "
                    f"threads at {r} registers need {need}, more than an "
                    f"SM's {REGS_PER_SM}",
                    hint="fewer CTAs per SM in the plan's wave count, or "
                         "a tighter __launch_bounds__", where=where)
    return None


def stage_rule(stage, *, where: str = "") -> Diagnostic | None:
    """``sm90.stage``: the staging kernel takes the plane
    (:func:`~repro_torch.kernels.conv_lb.im2col.stage_fits`)."""
    from repro_torch.kernels.conv_lb.im2col import stage_fits

    if stage_fits(*stage):
        return None
    b, h, w, ci, ho, wo, cp, elt = stage
    return _err("sm90.stage", f"the staging kernel does not take a {b} x "
                f"{ho} x {wo} x {cp} plane of a {h} x {w} x {ci} input "
                f"({elt}-byte words)", where=where)


def check_launch(facts: LaunchFacts, *, where: str = "") -> list[Diagnostic]:
    """Every ``sm90`` rule on one launch's facts."""
    diags = []
    for d in (smem_rule(facts.smem_bytes, facts.stages, where=where),
              grid_rule(facts.grid, where=where),
              regs_rule(facts.threads, facts.min_blocks, facts.ctas_per_sm,
                        facts.regs, where=where),
              None if facts.stage is None
              else stage_rule(facts.stage, where=where)):
        if d is not None:
            diags.append(d)
    diags += _box_rules([m.box for m in facts.maps],
                        [m.elem for m in facts.maps], where=where)
    for m in facts.maps:
        bad = [s for s in m.strides if s % TMA_ALIGN]
        if bad or not m.aligned:
            diags.append(_err(
                "sm90.tma", f"{m.operand}'s tensor map needs 16-byte "
                f"aligned global strides and base; strides {m.strides} B"
                f"{'' if m.aligned else ', base misaligned'}",
                hint="a channel count of 16 bytes' multiple, an aligned "
                     "allocation", where=where))
    diags += _args_rules(facts.args, where=where)
    return diags


#: the modules whose ``launch_facts`` describe each kernel entry point
LAUNCH_MODULES = {
    "conv_lb": "repro_torch.kernels.conv_lb.kernel",
    "conv_lb_dgrad": "repro_torch.kernels.conv_lb.kernel",
    "wgrad_lb": "repro_torch.kernels.conv_lb.wgrad",
    "matmul_lb": "repro_torch.kernels.matmul_lb.kernel",
    "attention": "repro_torch.kernels.attention_block.kernel",
}


def launch_facts(kernel: str, route: str, plan, shape,
                 dtype) -> tuple[LaunchFacts, ...]:
    """The launches one call of ``kernel`` makes on ``route`` with
    ``plan`` (the staging launch and the 1x1 launch of an im2col
    route), from the kernel module's own ``launch_facts``."""
    if kernel not in LAUNCH_MODULES:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{tuple(LAUNCH_MODULES)}")
    mod = importlib.import_module(LAUNCH_MODULES[kernel])
    return mod.launch_facts(kernel, route, plan, shape, dtype)


def check_launch_plan(kernel: str, route: str, plan, shape, dtype, *,
                      regs: dict | None = None,
                      where: str = "") -> list[Diagnostic]:
    """The ``sm90`` profile on one launch plan: ``kernel`` one of
    :data:`LAUNCH_MODULES`, ``route`` and ``plan`` what its ``plan_of``
    names, ``shape`` the call's geometry as that module's
    ``launch_facts`` reads it (``conv_lb``: ``(xshape, wshape, stride,
    padding, dilation, lhs_dilation, pool)``; ``conv_lb_dgrad``:
    ``(gyshape, wshape, stride, padding, dilation, h, wd)``;
    ``wgrad_lb``: ``(xshape, dyshape, WgradGeometry)``; ``matmul_lb``:
    ``(m, n, k, w_kmajor)``; ``attention``: ``(bh, sq, skv, hd,
    groups)``), ``dtype`` the operands' type.  ``regs`` maps a source
    stem to ``{kernel name: registers a thread}`` as read off the built
    library; a launch is held to the most of the kernels its
    ``function`` names.  A route ``fma`` is an ``sm90.fma`` warning."""
    diags = []
    if route == "fma":
        diags.append(Diagnostic(
            rule="sm90.fma", severity=WARN, where=where,
            message=f"{kernel} falls to its FMA route"))
    for facts in launch_facts(kernel, route, plan, shape, dtype):
        if regs:
            facts = with_registers(facts, regs)
        diags += check_launch(facts, where=where)
    return diags


def with_registers(facts: LaunchFacts, regs: dict) -> LaunchFacts:
    """``facts`` with the most registers a thread of the kernels its
    ``function`` names holds in ``regs`` (``{source: {kernel name:
    registers}}``); unchanged where ``regs`` names none of them."""
    found = [r for name, r in regs.get(facts.source, {}).items()
             if facts.function in name]
    return dataclasses.replace(facts, regs=max(found)) if found else facts


# --------------------------------------------------------------------------
# the audit
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanAuditEntry:
    """One plan's verdict: legality diagnostics + cross-audit flags;
    under ``sm90`` also the route and launch plan its kernel takes
    (``None`` under ``interpret``, and where the library rung runs the
    pass)."""

    name: str            # "<layer>/<pass>" e.g. "conv3_1/dgrad"
    diagnostics: tuple[Diagnostic, ...]
    traffic_ok: bool     # symbolic re-derivation == accountant
    bound_ok: bool       # symbolic Eq. (15) == ConvPlan.bound_words
    words: float         # accountant words at the audit batch
    bound: float         # bound words (0.0 where not applicable)
    route: str | None = None
    launch: object = None

    @property
    def legal(self) -> bool:
        return not errors(self.diagnostics)

    @property
    def ok(self) -> bool:
        return self.legal and self.traffic_ok and self.bound_ok


@dataclasses.dataclass(frozen=True)
class PlanAudit:
    """The audit over a set of plan handles."""

    entries: tuple[PlanAuditEntry, ...]
    target: str = TARGET_INTERPRET

    @property
    def n_plans(self) -> int:
        return len(self.entries)

    @property
    def n_legal(self) -> int:
        return sum(e.legal for e in self.entries)

    @property
    def legal_frac(self) -> float:
        return self.n_legal / max(1, self.n_plans)

    @property
    def traffic_mismatches(self) -> int:
        return sum(not e.traffic_ok for e in self.entries)

    @property
    def bound_mismatches(self) -> int:
        return sum(not e.bound_ok for e in self.entries)

    @property
    def ok(self) -> bool:
        return all(e.ok for e in self.entries)

    def errors(self) -> list[Diagnostic]:
        return [d for e in self.entries for d in errors(e.diagnostics)]

    def report(self) -> str:
        """Human-readable audit summary (one line per plan, details
        for anything that failed)."""
        lines = [f"plan audit [{self.target}]: {self.n_legal}/"
                 f"{self.n_plans} legal, "
                 f"{self.traffic_mismatches} traffic mismatch(es), "
                 f"{self.bound_mismatches} bound mismatch(es)"]
        for e in self.entries:
            flag = "ok " if e.ok else "BAD"
            lines.append(f"  {flag} {e.name}: {e.words:.3g} words"
                         + (f" vs bound {e.bound:.3g}" if e.bound
                            else "")
                         + (f" [{e.route}]" if e.route else ""))
            for d in e.diagnostics:
                if d.severity == ERROR or not e.legal:
                    lines.append(f"       {d}")
        return "\n".join(lines)


def _audit_conv(name, layer, plan, *, batch, dtype_bytes, vmem_budget,
                launch=None, regs=None) -> PlanAuditEntry:
    diags = check_conv_plan(plan, batch=batch, dtype_bytes=dtype_bytes,
                            vmem_budget=vmem_budget, where=name)
    acct = plan.traffic(batch)
    bound = plan.bound_words(layer) if layer is not None else 0.0
    return PlanAuditEntry(
        name=name,
        diagnostics=tuple(diags) + _launch_diags(launch, name, regs),
        traffic_ok=symbolic_conv_traffic(plan, batch) == acct,
        bound_ok=(layer is None
                  or symbolic_bound_words(plan, layer) == bound),
        words=acct.total, bound=bound, **_launch_fields(launch))


def _audit_wgrad(name, wplan, *, batch, dtype_bytes, vmem_budget,
                 launch=None, regs=None) -> PlanAuditEntry:
    diags = check_wgrad_plan(wplan, dtype_bytes=dtype_bytes,
                             vmem_budget=vmem_budget, where=name)
    acct = wplan.traffic(batch)
    return PlanAuditEntry(
        name=name,
        diagnostics=tuple(diags) + _launch_diags(launch, name, regs),
        traffic_ok=symbolic_wgrad_traffic(wplan, batch) == acct,
        bound_ok=True, words=acct.total, bound=0.0,
        **_launch_fields(launch))


def _launch_fields(launch) -> dict:
    if launch is None:
        return {}
    return {"route": launch[1], "launch": launch[2]}


def _launch_diags(launch, where: str, regs) -> tuple[Diagnostic, ...]:
    if launch is None or launch[0] is None:
        return ()
    return tuple(check_launch_plan(*launch, regs=regs, where=where))


def sm90_launches(layer, handle, *, batch: int, dtype):
    """The K1 and K2 launches of one handle at ``batch`` in ``dtype``,
    as the kernels' shape-only cores pick them: ``{pass: (kernel,
    route, plan, shape, dtype)}`` for ``fwd`` and, for a training
    handle, ``dgrad`` (``(None, "library", None, None, dtype)`` where
    the library rung takes dx) and ``wgrad``.  The backward's recompute
    (no epilogue) takes the forward's plan on every tensor-core route."""
    from repro_torch.kernels.conv_lb import kernel as K1
    from repro_torch.kernels.conv_lb import wgrad as K2

    fwd = handle.fwd if hasattr(handle, "fwd") else handle
    stride, padding = (layer.stride,) * 2, (layer.pad,) * 2
    xshape = (batch, layer.hi, layer.wi, layer.ci)
    wshape = (layer.hk, layer.wk, layer.ci, layer.co)
    conv = (xshape, wshape, stride, padding, tuple(fwd.dilation), (1, 1),
            fwd.pool)
    out = {"fwd": ("conv_lb", *K1.launch_plan(dtype, *conv), conv, dtype)}
    if hasattr(handle, "fwd"):
        gy = (batch, fwd.ho, fwd.wo, layer.co)
        if K1.dgrad_on_kernel(layer.hk, layer.wk, padding, fwd.dilation):
            out["dgrad"] = K1.dgrad_launch(dtype, gy, wshape, stride,
                                           padding, tuple(fwd.dilation),
                                           layer.hi, layer.wi)
        else:
            out["dgrad"] = (None, "library", None, None, dtype)
        geom = K2.WgradGeometry(hk=layer.hk, wk=layer.wk, stride=stride,
                                padding=padding,
                                dilation=tuple(fwd.dilation))
        out["wgrad"] = ("wgrad_lb",
                        *K2.launch_plan(dtype, xshape, layer.co, geom),
                        (xshape, gy, geom), dtype)
    return out


def audit_handles(handles, *, batch: int, dtype_bytes: int = 4,
                  vmem_budget: int | None = None,
                  target: str = TARGET_INTERPRET,
                  dtype=None, regs: dict | None = None) -> PlanAudit:
    """Audit ``[(ConvLayer, ConvPlan | ConvTrainingPlan)]`` handles (the
    :func:`~repro_torch.models.graph.graph_plan_handles` export): the
    legality pass on every constituent plan and the exact traffic/bound
    cross-audit against the accountant; under ``target="sm90"`` also
    each pass's launch plan at ``batch`` in ``dtype`` (a ``torch``
    type; default f32) against the card (:func:`check_launch_plan`,
    with ``regs`` where the built libraries' registers are known)."""
    if target == TARGET_MOSAIC:
        raise ValueError("the conv plans' mosaic profile is TPU "
                         "alignment, which has no counterpart on the "
                         "card; audit the launch plans at target='sm90'")
    if target not in (TARGET_INTERPRET, TARGET_SM90):
        raise ValueError(f"unknown audit target {target!r}")
    if target == TARGET_SM90 and dtype is None:
        import torch
        dtype = torch.float32
    kw = dict(batch=batch, dtype_bytes=dtype_bytes,
              vmem_budget=vmem_budget, regs=regs)
    entries = []
    for layer, handle in handles:
        launch = (sm90_launches(layer, handle, batch=batch, dtype=dtype)
                  if target == TARGET_SM90 else {})
        if hasattr(handle, "fwd"):        # ConvTrainingPlan triple
            entries.append(_audit_conv(f"{layer.name}/fwd", layer,
                                       handle.fwd, launch=launch.get("fwd"),
                                       **kw))
            # the dgrad conv is its own layer geometry; legality and
            # the traffic re-derivation apply, the fwd bound does not
            entries.append(_audit_conv(f"{layer.name}/dgrad", None,
                                       handle.dgrad,
                                       launch=launch.get("dgrad"), **kw))
            entries.append(_audit_wgrad(f"{layer.name}/wgrad",
                                        handle.wgrad,
                                        launch=launch.get("wgrad"), **kw))
        else:
            entries.append(_audit_conv(f"{layer.name}/fwd", layer,
                                       handle, launch=launch.get("fwd"),
                                       **kw))
    return PlanAudit(entries=tuple(entries), target=target)


def audit_graph(graph, h: int, w: int, *, batch: int, in_ch: int = 3,
                dtype_bytes: int = 4, vmem_budget: int | None = None,
                training: bool = True, target: str = TARGET_INTERPRET,
                dtype=None, regs: dict | None = None) -> PlanAudit:
    """Run the full static audit over every node of a conv graph:
    forward plans, and with ``training=True`` the planned dgrad/wgrad
    convs too — the ``plans checked / plans legal`` gate; under
    ``target="sm90"`` with each pass's launch plan in ``dtype``."""
    from repro_torch.models.graph import graph_plan_handles

    handles = graph_plan_handles(graph, h, w, batch=batch, in_ch=in_ch,
                                 dtype_bytes=dtype_bytes,
                                 vmem_budget=vmem_budget,
                                 training=training)
    return audit_handles(handles, batch=batch, dtype_bytes=dtype_bytes,
                         vmem_budget=vmem_budget, target=target,
                         dtype=dtype, regs=regs)
